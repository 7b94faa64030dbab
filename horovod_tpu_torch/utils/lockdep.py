"""Runtime lock-order sanitizer (``HVD_LOCKDEP=1``), the port of
``horovod_tpu/utils/lockdep.py``.

A drop-in instrumented lock that records, per thread, the stack of locks
held and the first-witness acquisition edges between named locks, and
reports

  * **order cycles**: thread 1 was seen taking A then B, thread 2 now
    takes B then A: the inversion, reported with both witness stacks
    even when the timing never lined up into a real deadlock;
  * **rank violations**: an acquisition that contradicts
    ``common/concurrency.py`` ``LOCK_RANKS`` (equal-or-lower rank taken
    while a ranked lock is held);
  * **self deadlock**: re-entry of a held non-reentrant lock, caught and
    reported before the thread hangs;
  * **hold-while-blocking**: a thread holding a lock blocked longer than
    ``HVD_LOCKDEP_STALL_S`` acquiring another.

Each finding is kept (``findings()``) and escalates as in the JAX
package: a metrics event (``lockdep_<kind>``), a warning, and a dump of
the tracing flight recorder (reason ``lockdep_<kind>``), whose event
ring then holds the finding beside the spans.

Cost: when ``HVD_LOCKDEP`` is unset, ``lock(name)`` returns a raw
``threading.Lock``: no instrumented code on any acquire or release.
"""

import os
import threading
import traceback

from ..common.concurrency import LOCK_RANKS

# Read per construction (not at import): tests and drills flip the env
# var around individual lock creations without re-importing.
_ENV = "HVD_LOCKDEP"
_ENV_STALL = "HVD_LOCKDEP_STALL_S"
_ENV_MAX = "HVD_LOCKDEP_MAX_FINDINGS"

_FALSY = ("", "0", "false", "False", "no")


def enabled():
    return os.environ.get(_ENV, "0") not in _FALSY


def lock(name, reentrant=False):
    """A lock for the named role (``ClassName.attr`` / ``module.global``
    — the LOCK_RANKS spelling). Raw ``threading.Lock``/``RLock`` when
    the sanitizer is off; an instrumented drop-in when on."""
    if not enabled():
        return threading.RLock() if reentrant else threading.Lock()
    return _SanitizedLock(name, reentrant=reentrant)


def rlock(name):
    return lock(name, reentrant=True)


# ---------------------------------------------------------------------------
# witness state (touched only by instrumented locks, i.e. only when on)
# ---------------------------------------------------------------------------

_tls = threading.local()
# internal mutex for the global tables below; deliberately raw — the
# sanitizer must not sanitize itself
_state_lock = threading.Lock()
_edges = {}      # guarded_by: _state_lock; (outer, inner) -> witness
_findings = []   # guarded_by: _state_lock
_finding_keys = set()  # guarded_by: _state_lock
_dropped = 0     # guarded_by: _state_lock; findings past the cap


def _held():
    st = getattr(_tls, "held", None)
    if st is None:
        st = _tls.held = []
    return st


def findings():
    """Copies of the findings so far (for drills and tests)."""
    with _state_lock:
        return [dict(f) for f in _findings]


def reset():
    """Drop all witness state (tests only: edges from one drill must
    not leak cycles into the next)."""
    global _dropped
    with _state_lock:
        _edges.clear()
        _findings.clear()
        _finding_keys.clear()
        _dropped = 0
    _tls.held = []


def _stall_s():
    try:
        return float(os.environ.get(_ENV_STALL, "1.0"))
    except ValueError:
        return 1.0


def _max_findings():
    try:
        return int(os.environ.get(_ENV_MAX, "32"))
    except ValueError:
        return 32


def _record(kind, detail):
    """Dedup, store, and escalate one finding. Runs escalation OUTSIDE
    _state_lock and guards against recursion through instrumented
    locks."""
    global _dropped
    # key on the SET of involved lock names: a cycle witnessed from
    # either direction is one finding, not two
    key = (kind,) + tuple(sorted(
        str(v) for k, v in detail.items() if k.startswith("lock")))
    with _state_lock:
        if key in _finding_keys:
            return
        if len(_findings) >= _max_findings():
            _dropped += 1
            return
        _finding_keys.add(key)
        finding = dict(detail, kind=kind,
                       thread=threading.current_thread().name)
        _findings.append(finding)
    if getattr(_tls, "escalating", False):
        return
    _tls.escalating = True
    try:
        _escalate(kind, finding)
    except Exception:  # noqa: BLE001 — diagnostics only: the finding is
        # stored; a broken sink must not take down the code under test
        pass
    finally:
        _tls.escalating = False


def _escalate(kind, finding):
    # ladder: structured event -> warning -> flight dump (the dump
    # snapshots the event ring, so a postmortem sees locks and stacks)
    from . import metrics as hvd_metrics
    from . import tracing as hvd_tracing
    from ..common import hvd_logging
    fields = {k: v for k, v in finding.items() if k != "kind"}
    hvd_metrics.get_registry().event(f"lockdep_{kind}", **fields)
    hvd_logging.warning(
        "lockdep: %s — %s (HVD_LOCKDEP sanitizer)", kind,
        ", ".join(f"{k}={v}" for k, v in fields.items()
                  if not k.startswith("stack")))
    hvd_tracing.get_tracer().dump(f"lockdep_{kind}")


def _stack():
    # drop the sanitizer's own frames; keep the caller's
    return "".join(traceback.format_stack(limit=12)[:-3])


class _SanitizedLock:
    """Instrumented drop-in for threading.Lock/RLock: context manager +
    acquire/release/locked, with order witnessing on every acquire."""

    def __init__(self, name, reentrant=False):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        # resolved at construction so the per-acquire path never
        # touches the environment
        self._stall = _stall_s()

    # -- witnessing ----------------------------------------------------

    def _before_acquire(self):
        held = _held()
        if not held:
            return
        # steady state (all edges witnessed, no violations) must stay a
        # few dict probes: the stack is only formatted on a first
        # witness or an actual finding
        stack_cache = []

        def stack():
            if not stack_cache:
                stack_cache.append(_stack())
            return stack_cache[0]

        rank = LOCK_RANKS.get(self.name)
        for outer in held:
            if outer == self.name:
                if not self.reentrant:
                    _record("self_deadlock", {
                        "lock": self.name, "stack": stack()})
                continue
            outer_rank = LOCK_RANKS.get(outer)
            if rank is not None and outer_rank is not None and \
                    rank <= outer_rank:
                _record("rank_violation", {
                    "lock_held": outer, "rank_held": outer_rank,
                    "lock_acquiring": self.name, "rank_acquiring": rank,
                    "stack": stack()})
        with _state_lock:
            cycle_with = None
            for outer in held:
                # about to witness outer -> self; a recorded path
                # self -> ... -> outer closes a cycle
                if outer != self.name and \
                        self._reaches(self.name, outer):
                    cycle_with = outer
                    break
            for outer in held:
                if outer != self.name and \
                        (outer, self.name) not in _edges:
                    _edges[(outer, self.name)] = {
                        "stack": stack(),
                        "thread": threading.current_thread().name}
            other = (_edges.get((self.name, cycle_with), {})
                     if cycle_with is not None else {})
        if cycle_with is not None:
            # this thread holds cycle_with (B) and is taking self (A);
            # the witnessed path A ->* B means another thread took A
            # then B. Report A-then-B (the prior witness) against
            # B-then-A (this very stack), naming both locks + stacks.
            _record("order_cycle", {
                "lock_a": self.name, "lock_b": cycle_with,
                "stack_a_then_b": other.get("stack", ""),
                "thread_a_then_b": other.get("thread", ""),
                "stack_b_then_a": stack()})

    @staticmethod
    def _reaches(src, dst):
        # DFS over the witnessed-order graph; caller holds _state_lock
        seen = set()
        work = [src]
        while work:
            cur = work.pop()
            if cur == dst:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            work.extend(b for (a, b) in _edges if a == cur)
        return False

    # -- lock protocol -------------------------------------------------

    def acquire(self, blocking=True, timeout=-1):
        self._before_acquire()
        if not blocking or timeout != -1:
            got = self._inner.acquire(blocking, timeout)
            if got:
                _held().append(self.name)
            return got
        got = self._inner.acquire(timeout=self._stall)
        if not got:
            held = _held()
            if held:
                _record("hold_while_blocking", {
                    "lock_blocked_on": self.name,
                    "locks_held": ",".join(held),
                    "stall_s": self._stall,
                    "stack": _stack()})
            self._inner.acquire()
        _held().append(self.name)
        return True

    def release(self):
        held = _held()
        # remove the innermost occurrence (RLocks may nest)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self.name:
                del held[i]
                break
        self._inner.release()

    def locked(self):
        probe = getattr(self._inner, "locked", None)
        if probe is not None:
            return probe()
        # RLock has no locked(); a failed non-blocking probe means held
        if self._inner.acquire(blocking=False):
            self._inner.release()
            return False
        return True

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<lockdep {self.name} held={self.name in _held()}>"
