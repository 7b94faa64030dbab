"""Continuous SLO alerting over the metrics registry, the port's copy
of ``horovod_tpu/utils/alerts.py``.

An :class:`AlertManager` evaluated on the existing instrument ticks
(``ServeEngine.step`` in the port; no second control loop, no thread)
runs declarative rules over registry metrics, multi-window burn-rate
predicates among them, through a ``pending -> firing -> resolved`` state
machine with for-duration hysteresis both ways.

A rule that reaches ``firing`` escalates in three steps: a registry
event (``alert_firing``), a ``logging.warning`` and, once per episode, a
flight dump (``reason="alert:<name>"``) plus an **incident file** in the
history directory bundling the alert window's history slice, its
events, the correlated trace and request ids, the stranded (admitted,
never retired) request ids and the dominant serve phase.

Burn rate: with an SLO target ``t``, the error budget is ``1 - t``; over
a window where ``good`` and ``bad`` units accrued, ``burn = (bad /
(good + bad)) / (1 - t)``. The default goodput rule fires only when both
a long and a short window burn hot.

Rules over metrics the port does not emit yet (HBM headroom, recompile
storms, nonfinites, route breaker trips) see an absent metric and never
breach.

Knobs: ``HVD_ALERT`` (default on), ``HVD_ALERT_INTERVAL_S`` (least
seconds between evaluations, default 1), ``HVD_ALERT_FOR_S`` (default
for-duration, 5), ``HVD_ALERT_TTFT_SLO_S``, ``HVD_ALERT_GOODPUT_SLO``,
``HVD_ALERT_GOODPUT_BURN``, ``HVD_ALERT_HBM_HEADROOM_FRAC``,
``HVD_ALERT_NONFINITE_BURST``, ``HVD_ALERT_BREAKER_FLAPS``.
"""

import bisect
import collections
import json
import logging
import os
import time

from . import history as hvd_history
from . import lockdep
from . import metrics as hvd_metrics

log = logging.getLogger("horovod_tpu_torch.alerts")

INCIDENT_VERSION = 1

# Rule states (also the hvd_alert_state gauge encoding).
INACTIVE, PENDING, FIRING = 0, 1, 2
_STATE_NAMES = {INACTIVE: "inactive", PENDING: "pending", FIRING: "firing"}


def _alerts_enabled():
    return str(hvd_metrics._env("ALERT", "1")).strip().lower() not in (
        "0", "false", "no", "off")


# ---------------------------------------------------------------------------
# shared window container (elasticity + alerting read one SLO truth)
# ---------------------------------------------------------------------------

class RollingWindow:
    """Rolling window with a retained last-full predecessor.

    ``factory()`` builds the accumulator (anything with ``observe()``
    and an ``n`` sample count; injected as a factory so utils never
    imports the serving plane). Semantics:

    * ``observe`` feeds the rolling accumulator; when it reaches
      ``size`` samples it becomes the new last-full and a fresh one
      starts.
    * ``recent()`` is the rolling accumulator if it has any samples,
      else the last full one — the freshest usable view.
    * ``freeze()`` returns the rolling accumulator as a baseline
      unless it is thinner than half a window and a last-full exists
      (then the last-full is the better baseline); either way the
      rolling accumulator restarts. The last-full is deliberately
      retained so an immediately-following ``recent()`` still has
      history.
    """

    __slots__ = ("size", "factory", "_rolling", "_last_full")

    def __init__(self, size, factory):
        self.size = int(size)
        self.factory = factory
        self._rolling = factory()
        self._last_full = None

    def observe(self, *args, **kwargs):
        self._rolling.observe(*args, **kwargs)
        if self._rolling.n >= self.size:
            self._last_full, self._rolling = self._rolling, self.factory()

    @property
    def current(self):
        """The in-progress accumulator (may be empty)."""
        return self._rolling

    @property
    def last_full(self):
        return self._last_full

    def recent(self):
        if self._rolling.n:
            return self._rolling
        return self._last_full

    def freeze(self):
        base = self._rolling
        if base.n < max(self.size // 2, 1) and self._last_full is not None:
            base = self._last_full
        self._rolling = self.factory()
        return base


def burn_rate(good, bad, target):
    """Error-budget burn rate: ``(bad/(good+bad)) / (1-target)``.

    0.0 when the window is empty; ``inf`` when the target leaves no
    budget (target >= 1) and any badness accrued."""
    total = good + bad
    if total <= 0 or bad <= 0:
        return 0.0
    err = bad / total
    budget = 1.0 - target
    if budget <= 0:
        return float("inf")
    return err / budget


# ---------------------------------------------------------------------------
# metric sampling + rule evaluation view
# ---------------------------------------------------------------------------

_MAX_SAMPLES = 720  # per key; at the 1s default interval = 12 minutes


class _Sampler:
    """Per-metric time series of (tick_time, value-or-counts) used for
    windowed deltas over cumulative counters and histograms."""

    __slots__ = ("times", "values")

    def __init__(self):
        self.times = collections.deque(maxlen=_MAX_SAMPLES)
        self.values = collections.deque(maxlen=_MAX_SAMPLES)

    def add(self, now, value):
        self.times.append(now)
        self.values.append(value)

    def at(self, t):
        """Latest sample at or before ``t`` (falls back to the oldest
        retained sample -> partial windows early in a run)."""
        if not self.times:
            return None
        idx = bisect.bisect_right(list(self.times), t) - 1
        if idx < 0:
            idx = 0
        return self.values[idx]


class RuleView:
    """What a rule predicate sees at evaluation time: the current
    registry snapshot plus windowed history of previously sampled
    values. All lookups tolerate absent metrics (0.0 / None)."""

    def __init__(self, snapshot, samplers, now):
        self.snapshot = snapshot
        self.now = now
        self._samplers = samplers
        self._metrics = snapshot.get("metrics", {})

    def _sum(self, entry, labels=None):
        want = dict(labels or {})
        total = 0.0
        for val in entry.get("values", ()):
            lv = val.get("labels", {})
            if want and any(lv.get(k) != v for k, v in want.items()):
                continue
            total += val["sum"] if "counts" in val else val.get("value", 0.0)
        return total

    def value(self, name, labels=None, default=0.0):
        """Current value (summed across label children, optionally
        filtered). Histograms yield their ``sum``."""
        entry = self._metrics.get(name)
        if entry is None:
            return default
        return self._sum(entry, labels)

    def has(self, name):
        return name in self._metrics

    def delta(self, name, window_s, labels=None):
        """Increase of a cumulative value over the trailing window
        (clamped at 0 — a registry reset is not a negative burst)."""
        cur = self.value(name, labels)
        sampler = self._samplers.get(("v", name, _labels_key(labels)))
        if sampler is None:
            return cur  # first sighting: whole lifetime is the window
        past = sampler.at(self.now - window_s)
        if past is None:
            return cur
        return max(cur - past, 0.0)

    def burn(self, good_name, bad_name, target, window_s,
             good_labels=None, bad_labels=None):
        """Multi-window building block: burn rate of ``bad`` against
        ``good`` deltas over the trailing window."""
        return burn_rate(self.delta(good_name, window_s, good_labels),
                         self.delta(bad_name, window_s, bad_labels),
                         target)

    def quantile(self, name, q, window_s=None):
        """Histogram quantile; with ``window_s`` computed over the
        bucket-count deltas of the trailing window (a rolling p99),
        else over the cumulative histogram. None when empty/absent."""
        entry = self._metrics.get(name)
        if entry is None or entry.get("type") != "histogram":
            return None
        bounds = entry.get("buckets", ())
        counts = [0] * (len(bounds) + 1)
        for val in entry.get("values", ()):
            for i, c in enumerate(val.get("counts", ())):
                if i < len(counts):
                    counts[i] += c
        if window_s is not None:
            sampler = self._samplers.get(("h", name))
            past = sampler.at(self.now - window_s) if sampler else None
            if past is not None:
                counts = [max(c - p, 0) for c, p in zip(counts, past)]
        if sum(counts) <= 0:
            return None
        return hvd_metrics.histogram_quantile(bounds, counts, q)

    def window_count(self, name, window_s):
        """Observation count a windowed quantile would be based on."""
        entry = self._metrics.get(name)
        if entry is None or entry.get("type") != "histogram":
            return 0
        counts = [0] * (len(entry.get("buckets", ())) + 1)
        for val in entry.get("values", ()):
            for i, c in enumerate(val.get("counts", ())):
                if i < len(counts):
                    counts[i] += c
        sampler = self._samplers.get(("h", name))
        past = sampler.at(self.now - window_s) if sampler else None
        if past is not None:
            counts = [max(c - p, 0) for c, p in zip(counts, past)]
        return int(sum(counts))


def _labels_key(labels):
    return tuple(sorted((labels or {}).items()))


class Rule:
    """One declarative alert rule.

    ``predicate(view) -> (breach, evidence)`` where ``view`` is a
    :class:`RuleView`; ``evidence`` is a small JSON-able dict carried
    on every lifecycle event and into the incident file. ``for_s`` is
    the breach-hold before ``pending`` escalates to ``firing``;
    ``clear_s`` (default ``for_s``) the clear-hold before ``firing``
    resolves — hysteresis in both directions so a flapping signal
    neither pages nor un-pages per tick. ``sample`` lists
    ``("v", name, labels)`` / ``("h", name)`` keys the manager must
    record each tick for the rule's windowed lookups.
    """

    __slots__ = ("name", "predicate", "for_s", "clear_s", "severity",
                 "description", "sample")

    def __init__(self, name, predicate, for_s=None, clear_s=None,
                 severity="warn", description="", sample=()):
        if for_s is None:
            for_s = float(hvd_metrics._env("ALERT_FOR_S", 5.0))
        self.name = name
        self.predicate = predicate
        self.for_s = float(for_s)
        self.clear_s = self.for_s if clear_s is None else float(clear_s)
        self.severity = severity
        self.description = description
        self.sample = tuple(sample)


class _RuleState:
    __slots__ = ("state", "since", "clear_since", "dumped", "episode",
                 "last_evidence")

    def __init__(self):
        self.state = INACTIVE
        self.since = None        # entered current state at
        self.clear_since = None  # firing only: clear streak start
        self.dumped = False      # one-shot flight dump per episode
        self.episode = 0
        self.last_evidence = {}


# ---------------------------------------------------------------------------
# default rule pack
# ---------------------------------------------------------------------------

def default_rules():
    """The stock rule pack (docs/alerts.md has the table).

    Thresholds come from HVD_ALERT_* knobs read at pack construction
    (i.e. at ``reset()``/first use, not per tick)."""
    ttft_slo = float(hvd_metrics._env("ALERT_TTFT_SLO_S", 2.0))
    goodput_slo = float(hvd_metrics._env("ALERT_GOODPUT_SLO", 0.9))
    burn_hot = float(hvd_metrics._env("ALERT_GOODPUT_BURN", 2.0))
    headroom_frac = float(hvd_metrics._env("ALERT_HBM_HEADROOM_FRAC", 0.10))
    nonfinite_burst = float(hvd_metrics._env("ALERT_NONFINITE_BURST", 3))
    breaker_flaps = float(hvd_metrics._env("ALERT_BREAKER_FLAPS", 3))

    def goodput_burn(view):
        # Multi-window: the long window proves material budget spend,
        # the short window proves it is still happening.
        long_b = view.burn("hvd_serve_goodput_tokens_total",
                           "hvd_serve_wasted_tokens_total",
                           goodput_slo, 60.0)
        short_b = view.burn("hvd_serve_goodput_tokens_total",
                            "hvd_serve_wasted_tokens_total",
                            goodput_slo, 15.0)
        breach = long_b >= burn_hot and short_b >= burn_hot
        return breach, {"burn_60s": round(long_b, 3),
                        "burn_15s": round(short_b, 3),
                        "slo": goodput_slo, "threshold": burn_hot}

    def ttft_slo_rule(view):
        if view.window_count("hvd_serve_ttft_seconds", 60.0) < 5:
            return False, {}
        p99 = view.quantile("hvd_serve_ttft_seconds", 0.99, window_s=60.0)
        if p99 is None:
            return False, {}
        return p99 > ttft_slo, {"ttft_p99_s": round(p99, 4),
                                "slo_s": ttft_slo}

    def hbm_headroom(view):
        if not view.has("hvd_hbm_capacity_bytes"):
            return False, {}
        cap = view.value("hvd_hbm_capacity_bytes")
        if cap <= 0:
            return False, {}
        head = view.value("hvd_hbm_headroom_bytes")
        frac = head / cap
        return frac < headroom_frac, {
            "headroom_frac": round(frac, 4), "threshold": headroom_frac,
            "headroom_bytes": int(head)}

    def recompile_storm(view):
        storms = view.delta("hvd_recompile_storms_total", 120.0)
        return storms > 0, {"storms_120s": storms}

    def stall(view):
        ranks = view.value("hvd_stalled_ranks")
        tensors = view.value("hvd_coordinator_stalled_tensors") + \
            view.value("hvd_stalled_tensors")
        return (ranks > 0 or tensors > 0), {
            "stalled_ranks": ranks, "stalled_tensors": tensors}

    def nonfinite(view):
        burst = view.delta("hvd_nonfinite_total", 60.0)
        return burst >= nonfinite_burst, {
            "nonfinite_60s": burst, "threshold": nonfinite_burst}

    def breaker_flap(view):
        trips = view.delta("hvd_route_breaker_trips_total", 300.0)
        return trips >= breaker_flaps, {
            "trips_300s": trips, "threshold": breaker_flaps}

    return [
        Rule("serve_goodput_burn", goodput_burn, severity="page",
             description="Serve goodput error budget burning at "
                         f">= {burn_hot}x over both 60s and 15s windows.",
             sample=(("v", "hvd_serve_goodput_tokens_total", None),
                     ("v", "hvd_serve_wasted_tokens_total", None))),
        Rule("serve_ttft_p99", ttft_slo_rule, severity="page",
             description=f"Rolling 60s TTFT p99 above the {ttft_slo}s SLO.",
             sample=(("h", "hvd_serve_ttft_seconds"),)),
        Rule("hbm_headroom_low", hbm_headroom, severity="warn",
             description="HBM headroom under "
                         f"{headroom_frac:.0%} of capacity."),
        Rule("recompile_storm", recompile_storm, severity="warn",
             description="Recompile storm detected in the last 120s.",
             sample=(("v", "hvd_recompile_storms_total", None),)),
        Rule("stall", stall, severity="page",
             description="Ranks or collective tensors stalled."),
        Rule("nonfinite_burst", nonfinite, severity="page",
             description="Nonfinite gradients/activations bursting "
                         f"(>= {nonfinite_burst:g}/60s).",
             sample=(("v", "hvd_nonfinite_total", None),)),
        Rule("breaker_flap", breaker_flap, severity="warn",
             description="Route circuit breaker flapping "
                         f"(>= {breaker_flaps:g} trips/300s).",
             sample=(("v", "hvd_route_breaker_trips_total", None),)),
    ]


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

class AlertManager:
    """Evaluates the rule set against the registry on instrument ticks.

    ``tick(now)`` is designed for the hot path: a lock-free interval
    check, then a non-blocking lock acquire (a concurrent tick simply
    yields), then one registry snapshot and one pass over the rules.
    ``now`` is the caller's clock domain (``time.monotonic()`` in
    production, virtual clocks in drills) and must stay consistent.

    Lock order: ``_lock`` ranks BELOW the tracer lock so firing-path
    escalation may dump a flight recorder, and below the history
    writer's ``_cv`` so incident capture may force a flush.
    """

    def __init__(self, registry=None, rules=None, interval_s=None,
                 incident_dir=None, history_writer=None):
        if interval_s is None:
            interval_s = float(hvd_metrics._env("ALERT_INTERVAL_S", 1.0))
        self.interval_s = max(float(interval_s), 0.0)
        self.rules = list(default_rules() if rules is None else rules)
        self._registry = registry
        self._incident_dir = incident_dir
        self._history_writer = history_writer
        self._lock = lockdep.lock("AlertManager._lock")
        self._next_due = None    # caller-clock deadline; torn reads OK
        self._states = {r.name: _RuleState() for r in self.rules}
        self._samplers = {}      # guarded_by: _lock
        self._incident_seq = 0   # guarded_by: _lock
        self.incidents = []      # guarded_by: _lock; paths written
        reg = hvd_metrics.get_registry() if registry is None else registry
        self._m_state = reg.gauge(
            "hvd_alert_state",
            "Alert rule state: 0 inactive, 1 pending, 2 firing.",
            labels=("alert",))
        self._m_trans = reg.counter(
            "hvd_alerts_total", "Alert lifecycle transitions.",
            labels=("alert", "transition"))
        self._m_incidents = reg.counter(
            "hvd_incidents_total", "Incident files written.",
            labels=("alert",))

    @property
    def enabled(self):
        return True

    def firing(self):
        """Names of rules currently firing (for panes and tests)."""
        with self._lock:
            return sorted(n for n, s in self._states.items()
                          if s.state == FIRING)

    def states(self):
        """{name: {"state", "severity", "evidence"}} snapshot."""
        by_name = {r.name: r for r in self.rules}
        with self._lock:
            return {
                n: {"state": _STATE_NAMES[s.state],
                    "severity": by_name[n].severity,
                    "evidence": dict(s.last_evidence)}
                for n, s in self._states.items()}

    # -- hot path --

    def tick(self, now=None):
        if now is None:
            now = time.monotonic()
        due = self._next_due
        if due is not None and now < due:
            return
        if not self._lock.acquire(blocking=False):
            return  # another tick is mid-evaluation
        try:
            if self._next_due is not None and now < self._next_due:
                return
            self._next_due = now + self.interval_s
            self._evaluate(now)
        finally:
            self._lock.release()

    # -- evaluation (holding _lock) --

    def _evaluate(self, now):
        reg = (hvd_metrics.get_registry() if self._registry is None
               else self._registry)
        snap = reg.snapshot(max_events=0)
        view = RuleView(snap, self._samplers, now)
        for rule in self.rules:
            breach, evidence = False, {}
            try:
                breach, evidence = rule.predicate(view)
            except Exception:  # noqa: BLE001 — rule isolation
                log.exception("alert rule %s predicate failed", rule.name)
            self._advance(reg, rule, bool(breach), evidence or {}, now)
        self._record_samples(view, now)

    def _record_samples(self, view, now):
        for rule in self.rules:
            for key in rule.sample:
                if key[0] == "v":
                    _, name, labels = key
                    skey = ("v", name, _labels_key(labels))
                    val = view.value(name, labels)
                elif key[0] == "h":
                    _, name = key
                    skey = ("h", name)
                    entry = view.snapshot.get("metrics", {}).get(name)
                    if entry is None or entry.get("type") != "histogram":
                        continue
                    counts = [0] * (len(entry.get("buckets", ())) + 1)
                    for v in entry.get("values", ()):
                        for i, c in enumerate(v.get("counts", ())):
                            if i < len(counts):
                                counts[i] += c
                    val = counts
                else:
                    continue
                sampler = self._samplers.get(skey)
                if sampler is None:
                    sampler = self._samplers[skey] = _Sampler()
                sampler.add(now, val)

    def _advance(self, reg, rule, breach, evidence, now):
        st = self._states[rule.name]
        if breach:
            st.last_evidence = evidence
        if st.state == INACTIVE:
            if breach:
                st.state, st.since = PENDING, now
                st.episode += 1
                st.dumped = False
                self._transition(reg, rule, "pending", evidence, now)
                # A zero for-duration fires on the same tick.
                if now - st.since >= rule.for_s:
                    self._fire(reg, rule, st, evidence, now)
        elif st.state == PENDING:
            if not breach:
                st.state, st.since = INACTIVE, None
                self._transition(reg, rule, "cancelled", evidence, now)
            elif now - st.since >= rule.for_s:
                self._fire(reg, rule, st, evidence, now)
        elif st.state == FIRING:
            if breach:
                st.clear_since = None
            else:
                if st.clear_since is None:
                    st.clear_since = now
                if now - st.clear_since >= rule.clear_s:
                    st.state, st.since, st.clear_since = INACTIVE, None, None
                    self._transition(reg, rule, "resolved",
                                     st.last_evidence, now)
        self._m_state.labels(alert=rule.name).set(float(st.state))

    def _transition(self, reg, rule, transition, evidence, now):
        self._m_trans.labels(alert=rule.name, transition=transition).inc()
        reg.event(f"alert_{transition}", alert=rule.name,
                  severity=rule.severity, **_jsonable(evidence))

    def _fire(self, reg, rule, st, evidence, now):
        st.state, st.since, st.clear_since = FIRING, now, None
        self._transition(reg, rule, "firing", evidence, now)
        log.warning("ALERT firing: %s (%s) %s — %s", rule.name,
                    rule.severity, evidence, rule.description)
        if not st.dumped:
            st.dumped = True
            self._escalate(reg, rule, st, evidence, now)

    # -- escalation: one-shot per episode, never raises --

    def _escalate(self, reg, rule, st, evidence, now):
        try:
            from . import tracing as hvd_tracing
            hvd_tracing.dump_on_failure(f"alert:{rule.name}")
        except Exception:  # noqa: BLE001 — escalation is best-effort
            log.exception("alert %s: flight dump failed", rule.name)
        try:
            path = self._write_incident(reg, rule, st, evidence, now)
            if path:
                self.incidents.append(path)
                self._m_incidents.labels(alert=rule.name).inc()
                reg.event("alert_incident", alert=rule.name, path=path)
                log.warning("ALERT incident written: %s", path)
        except Exception:  # noqa: BLE001 — escalation is best-effort
            log.exception("alert %s: incident capture failed", rule.name)

    def _write_incident(self, reg, rule, st, evidence, now):
        """Bundle the alert window's durable history slice + correlated
        ids into ``incident-<alert>-<seq>.json`` next to the WAL."""
        writer = self._history_writer or hvd_history.get_writer()
        out_dir = self._incident_dir or writer.dir or \
            hvd_history.history_dir()
        if not out_dir:
            return None
        writer.flush(wait=True)
        lookback_s = max(rule.for_s * 4, 60.0)
        fired_epoch_us = reg.clock.epoch_us()
        start_epoch_us = fired_epoch_us - int(lookback_s * 1e6)
        rank = writer.rank or 0
        records, _ = hvd_history.read_records(out_dir, rank)
        window_records = [r for r in records
                         if r.get("epoch_us", 0) >= start_epoch_us]
        all_events, _ = hvd_history.read_events(records)
        if not all_events:
            all_events = reg.events()  # WAL empty/disabled: live ring
        window_events = [e for e in all_events
                         if e.get("epoch_us", 0) >= start_epoch_us]
        retired, admitted = set(), {}
        phase_ms = collections.Counter()
        trace_ids, request_ids = set(), set()
        for ev in all_events:
            rid = ev.get("request_id")
            if ev.get("event") == "serve_admit" and rid is not None:
                admitted[rid] = ev
            elif ev.get("event") == "serve_retire" and rid is not None:
                retired.add(rid)
        for ev in window_events:
            rid = ev.get("request_id")
            if rid is not None:
                request_ids.add(rid)
            tid = ev.get("trace_id")
            if tid is not None:
                trace_ids.add(tid)
            if ev.get("event") == "serve_retire":
                for phase, ms in (ev.get("phase_ms") or {}).items():
                    phase_ms[phase] += ms
        stranded = sorted(set(admitted) - retired)
        dominant = phase_ms.most_common(1)[0][0] if phase_ms else None
        self._incident_seq += 1
        incident = {
            "version": INCIDENT_VERSION,
            "alert": rule.name,
            "severity": rule.severity,
            "description": rule.description,
            "episode": st.episode,
            "pending_for_s": rule.for_s,
            "fired_epoch_us": fired_epoch_us,
            "window_start_epoch_us": start_epoch_us,
            "evidence": _jsonable(evidence),
            "dominant_phase": dominant,
            "phase_ms": dict(phase_ms),
            "request_ids": sorted(request_ids),
            "trace_ids": sorted(trace_ids),
            "stranded_request_ids": stranded,
            "manifest": hvd_history.load_manifest(out_dir),
            "events": window_events[-hvd_metrics.MetricsRegistry.EVENT_RING:],
            "history": window_records,
        }
        path = os.path.join(
            out_dir, f"incident-{rule.name}-{self._incident_seq:03d}.json")
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(incident, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path


def _jsonable(d):
    out = {}
    for k, v in (d or {}).items():
        try:
            json.dumps(v)
            out[k] = v
        except (TypeError, ValueError):
            out[k] = repr(v)
    return out


class NullAlertManager:
    """Absorbs every call when alerting is disabled (HVD_ALERT=0)."""

    rules = ()
    incidents = ()

    @property
    def enabled(self):
        return False

    def tick(self, now=None):
        pass

    def firing(self):
        return []

    def states(self):
        return {}


# ---------------------------------------------------------------------------
# module singleton
# ---------------------------------------------------------------------------

_manager = None  # guarded_by: _manager_lock
_manager_lock = lockdep.lock("alerts._manager_lock")


def get_manager():
    """The process-wide alert manager (created on first use; honors
    HVD_ALERT=0 with a no-op manager)."""
    global _manager
    mgr = _manager
    if mgr is None:
        with _manager_lock:
            if _manager is None:
                _manager = (AlertManager() if _alerts_enabled()
                            else NullAlertManager())
            mgr = _manager
    return mgr


def reset(enabled=None, **kw):
    """Replace the process manager (tests; re-init after env changes).
    ``enabled``: None re-reads HVD_ALERT, True/False forces."""
    global _manager
    with _manager_lock:
        if enabled is None:
            _manager = None
        elif enabled:
            _manager = AlertManager(**kw)
            return _manager
        else:
            _manager = NullAlertManager()
            return _manager
    return get_manager()


def tick(now=None):
    get_manager().tick(now)
