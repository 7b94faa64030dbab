"""Elasticity plane: SLO pressure drives the replica set, the port of
``horovod_tpu/router/elastic.py``.

  * ``ElasticityController``, ticked from ``Router.step()``. Rolling
    windows over p99 TTFT (SLOWindow, shared with the canary), the
    fleet's aggregate queue depth and free KV blocks drive scale-up and
    scale-down proposals through hysteresis: the pressure (or idle)
    condition must hold for ``HVD_ELASTIC_DWELL_S`` continuously, and any
    executed change opens a ``HVD_ELASTIC_COOLDOWN_S`` cooldown. A
    scale-up spawns through the supervisor hook; a scale-down picks the
    least-loaded replica and drains it gracefully
    (``Router.begin_drain``). Every executed change is then graded
    exactly like a weight rollout: the pre-change SLOWindow is frozen as
    the baseline, a fresh window accumulates after the change, and the
    canary's breach math (``canary.slo_breaches``) gives the verdict. A
    scale-down that breaches rolls back by respawning.

  * ``CircuitBreaker``: per-replica dispatch health. A replica whose
    dispatches keep failing, whose load snapshot goes stale, or whose
    oldest in-flight request wedges past ``HVD_ELASTIC_BREAKER_TIMEOUT_S``
    trips open: it receives one probe request per ``HVD_ELASTIC_PROBE_S``
    until a probe succeeds (half-open), then closes after
    ``HVD_ELASTIC_BREAKER_CLOSE_N`` consecutive successes.

Both emit decision events with their evidence (``route_elastic_*``,
``route_breaker``), and neither ever leaves a request with nowhere to go.
"""

import time

from ..common import config
from ..utils import alerts as hvd_alerts
from ..utils import metrics as hvd_metrics
from . import policy as route_policy
from .canary import SLOWindow, slo_breaches

# breaker states, also the value of the per-replica state gauge
CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class _BreakerEntry:
    __slots__ = ("state", "fails", "opened_ts", "last_probe_ts",
                 "probes_ok", "reason")

    def __init__(self):
        self.state = CLOSED
        self.fails = 0
        self.opened_ts = None
        self.last_probe_ts = None
        self.probes_ok = 0
        self.reason = ""


class CircuitBreaker:
    """Per-replica dispatch circuit breaker (closed -> open ->
    half-open -> closed). The Router consults ``filter`` per dispatch,
    reports outcomes via ``record_success``/``record_failure``, and
    feeds the staleness/wedge signals via ``note_stale``/
    ``note_wedged``."""

    def __init__(self, fails=None, probe_s=None, close_n=None,
                 timeout_s=None, clock=time.monotonic):
        self.fails = (config.env_int("ELASTIC_BREAKER_FAILS", 3)
                      if fails is None else int(fails))
        self.probe_s = (config.env_float("ELASTIC_PROBE_S", 2.0)
                        if probe_s is None else float(probe_s))
        self.close_n = (config.env_int("ELASTIC_BREAKER_CLOSE_N", 3)
                        if close_n is None else int(close_n))
        self.timeout_s = (
            config.env_float("ELASTIC_BREAKER_TIMEOUT_S", 10.0)
            if timeout_s is None else float(timeout_s))
        self._clock = clock
        self._entries = {}
        reg = self._metrics = hvd_metrics.get_registry()
        self._m_state = reg.gauge(
            "hvd_route_breaker_state",
            "Circuit-breaker state per replica "
            "(0 closed, 1 half-open, 2 open).", labels=("replica",))
        self._m_trips = reg.counter(
            "hvd_route_breaker_trips_total",
            "Circuit-breaker trips (closed/half-open -> open), by what "
            "tripped them.", labels=("reason",))

    def _entry(self, rid):
        ent = self._entries.get(rid)
        if ent is None:
            ent = self._entries[rid] = _BreakerEntry()
            self._m_state.labels(replica=str(rid)).set(0)
        return ent

    def state(self, rid):
        return self._entry(rid).state

    def filter(self, candidates):
        """Split ``candidates`` into (allowed, probe): replicas whose
        breaker is closed/half-open, plus at most ONE open replica
        whose probe timer has fired (probe traffic — the caller must
        route the request there and call ``mark_probe``)."""
        now = self._clock()
        allowed, probe = [], None
        for rid in candidates:
            ent = self._entry(rid)
            if ent.state != OPEN:
                allowed.append(rid)
            elif probe is None and (
                    ent.last_probe_ts is None or
                    now - ent.last_probe_ts >= self.probe_s):
                probe = rid
        return allowed, probe

    def mark_probe(self, rid):
        self._entry(rid).last_probe_ts = self._clock()

    def record_success(self, rid):
        ent = self._entry(rid)
        ent.fails = 0
        if ent.state == OPEN:
            self._transition(rid, ent, HALF_OPEN, "probe_succeeded")
            ent.probes_ok = 1
            if ent.probes_ok >= self.close_n:
                self._transition(rid, ent, CLOSED, "recovered")
        elif ent.state == HALF_OPEN:
            ent.probes_ok += 1
            if ent.probes_ok >= self.close_n:
                self._transition(rid, ent, CLOSED, "recovered")

    def record_failure(self, rid, reason="dispatch_failed"):
        ent = self._entry(rid)
        if ent.state == HALF_OPEN:
            self._trip(rid, ent, f"half_open_{reason}")
            return
        ent.fails += 1
        if ent.state == CLOSED and ent.fails >= self.fails:
            self._trip(rid, ent, reason)

    def note_stale(self, rid):
        """The router excluded this replica for a stale load snapshot
        (heartbeat went silent while the process may still be alive)."""
        ent = self._entry(rid)
        if ent.state != OPEN:
            self._trip(rid, ent, "stale_snapshot")

    def note_wedged(self, rid, age_s):
        """This replica's oldest in-flight dispatch exceeded
        ``timeout_s`` — it heartbeats but does not finish work."""
        ent = self._entry(rid)
        if ent.state != OPEN:
            self._trip(rid, ent, "wedged", age_s=round(age_s, 3))

    def _trip(self, rid, ent, reason, **extra):
        ent.fails = 0
        ent.probes_ok = 0
        ent.opened_ts = self._clock()
        # the first probe waits a full probe interval: an instant
        # re-dispatch to a replica that just failed is not a probe
        ent.last_probe_ts = ent.opened_ts
        ent.reason = reason
        self._m_trips.labels(reason=reason).inc()
        self._transition(rid, ent, OPEN, reason, **extra)

    def _transition(self, rid, ent, state, reason, **extra):
        ent.state = state
        self._m_state.labels(replica=str(rid)).set(_STATE_GAUGE[state])
        self._metrics.event("route_breaker", replica=rid, state=state,
                            reason=reason, **extra)


class ElasticityController:
    """SLO pressure -> replica-set changes, one change at a time.

    ``spawn`` is the supervisor hook: ``spawn(router) -> replica_id``
    (or None when the spawn is asynchronous — the supervisor calls
    ``router.add_replica`` once the replica is live; the router parks
    orphaned reroutes against the pending spawn either way). Scale-
    downs go through ``router.begin_drain``. The Router calls
    ``observe`` per terminal result and ``tick`` per step.
    """

    def __init__(self, spawn=None, min_replicas=None, max_replicas=None,
                 dwell_s=None, cooldown_s=None, ttft_slo_s=None,
                 up_depth=None, down_util=None, window=None,
                 ttft_x=None, min_delta_s=None, goodput_drop=None,
                 clock=time.monotonic):
        self._spawn = spawn
        self.min_replicas = (config.env_int("ELASTIC_MIN_REPLICAS", 1)
                             if min_replicas is None else int(min_replicas))
        self.max_replicas = (config.env_int("ELASTIC_MAX_REPLICAS", 0)
                             if max_replicas is None else int(max_replicas))
        self.dwell_s = (config.env_float("ELASTIC_DWELL_S", 5.0)
                        if dwell_s is None else float(dwell_s))
        self.cooldown_s = (config.env_float("ELASTIC_COOLDOWN_S", 10.0)
                           if cooldown_s is None else float(cooldown_s))
        self.ttft_slo_s = (config.env_float("ELASTIC_TTFT_SLO_S", 1.0)
                           if ttft_slo_s is None else float(ttft_slo_s))
        self.up_depth = (config.env_float("ELASTIC_UP_DEPTH", 4.0)
                         if up_depth is None else float(up_depth))
        self.down_util = (config.env_float("ELASTIC_DOWN_UTIL", 0.25)
                          if down_util is None else float(down_util))
        # grading knobs are the CANARY's: a topology change is judged
        # by the same thresholds as a weight rollout, by construction
        self.window = (config.env_int("ROUTE_CANARY_WINDOW", 24)
                       if window is None else int(window))
        self.ttft_x = (config.env_float("ROUTE_CANARY_TTFT_X", 1.5)
                       if ttft_x is None else float(ttft_x))
        self.min_delta_s = (
            config.env_float("ROUTE_CANARY_MIN_DELTA_S", 0.025)
            if min_delta_s is None else float(min_delta_s))
        self.goodput_drop = (
            config.env_float("ROUTE_CANARY_GOODPUT_DROP", 0.10)
            if goodput_drop is None else float(goodput_drop))
        self._clock = clock
        self.state = "steady"          # steady | grading
        self.decisions = []            # (verdict, evidence) history
        self.transitions = []          # every state change, for drills
        # One source of SLO-window truth: the
        # rolling/last-full container is the shared helper the alert
        # rules' burn-rate math builds on, parameterized by the
        # canary's SLOWindow accumulator.
        self._win = hvd_alerts.RollingWindow(self.window, SLOWindow)
        self._grade = None
        self._pressure_since = None
        self._idle_since = None
        self._last_change_ts = None
        self._change_seq = 0
        reg = self._metrics = hvd_metrics.get_registry()
        self._m_changes = reg.counter(
            "hvd_elastic_changes_total",
            "Replica-set changes the elasticity controller executed, "
            "by action (scale_up/scale_down/rollback).",
            labels=("action",))
        self._m_pressure = reg.gauge(
            "hvd_elastic_pressure",
            "Elasticity pressure signal (1 scale-up pressure, "
            "-1 idle, 0 in band).")
        self._m_pressure.set(0)

    # -- signal intake --------------------------------------------------

    def observe(self, result):
        """One terminal RequestResult from the router's step loop."""
        self._win.observe(result)
        if self._grade is not None:
            self._grade["after"].observe(result)

    def _recent_window(self):
        return self._win.recent()

    def _freeze_baseline(self):
        """Snapshot the pre-change SLO window (the grading baseline)
        and start accumulation fresh, so post-change results can never
        contaminate the 'before' evidence."""
        return self._win.freeze()

    # -- the control loop (ticked from Router.step) ---------------------

    def tick(self, router, loads, now):
        if self._grade is not None:
            self._maybe_grade(router, now)
        live = router.live_replicas()
        if not live:
            return
        snaps = [loads.get(r) or {} for r in live]
        depth = sum(s.get("queue_depth") or 0 for s in snaps)
        active = sum(s.get("active_slots") or 0 for s in snaps)
        free_slots = sum(s.get("free_slots") or 0 for s in snaps)
        # KV starvation prefers the memory plane's OOM forecast when a
        # replica reports it: predicted_free_blocks
        # discounts queued-but-unadmitted work, so pressure fires one
        # queue-drain EARLIER than waiting for free_blocks to hit zero.
        def _kv_headroom(s):
            p = s.get("predicted_free_blocks")
            return p if p is not None else s.get("free_blocks")

        reported = [s for s in snaps if _kv_headroom(s) is not None]
        kv_starved = bool(reported) and all(
            _kv_headroom(s) <= 0 for s in reported)
        win = self._recent_window()
        ttft = win.ttft_p99() if win is not None and win.n else None
        pressure = (depth / len(live) >= self.up_depth or kv_starved or
                    (self.ttft_slo_s > 0 and ttft is not None and
                     ttft > self.ttft_slo_s))
        idle = (not pressure and depth == 0 and
                (active + free_slots) > 0 and
                active / (active + free_slots) <= self.down_util)
        self._m_pressure.set(1 if pressure else (-1 if idle else 0))
        # explicit None checks: a dwell that started at t=0.0 is falsy
        if pressure:
            if self._pressure_since is None:
                self._pressure_since = now
        else:
            self._pressure_since = None
        if idle:
            if self._idle_since is None:
                self._idle_since = now
        else:
            self._idle_since = None
        if self._grade is not None:
            return  # one change at a time: grade before proposing
        if self._last_change_ts is not None and \
                now - self._last_change_ts < self.cooldown_s:
            return  # cooldown after any change
        signals = {"live": len(live), "queue_depth": depth,
                   "kv_starved": kv_starved,
                   "ttft_p99": None if ttft is None else round(ttft, 6),
                   "util": round(active / (active + free_slots), 4)
                   if (active + free_slots) else None}
        if pressure and now - self._pressure_since >= self.dwell_s:
            if not self.max_replicas or len(live) < self.max_replicas:
                self._execute(router, "scale_up", signals, now)
        elif idle and now - self._idle_since >= self.dwell_s and \
                len(live) > self.min_replicas:
            self._execute(router, "scale_down", signals, now,
                          victim=self._pick_victim(live, loads))

    def _pick_victim(self, live, loads):
        """Drain the cheapest replica to lose: lowest dispatch cost,
        highest id on ties (retire the newest first)."""
        return min(live, key=lambda r: (route_policy.score(loads.get(r)),
                                        -r))

    def _execute(self, router, action, signals, now, victim=None):
        self._change_seq += 1
        baseline = self._freeze_baseline()
        detail = dict(signals, change_id=self._change_seq)
        if action == "scale_up":
            if self._spawn is None:
                return  # nothing to execute with — stay steady
            router.note_spawn_pending()
            detail["replica"] = self._spawn(router)
        else:
            if not router.begin_drain(victim):
                return
            detail["replica"] = victim
        self.state = "grading"
        self._grade = {"action": action, "replica": detail["replica"],
                       "change_id": self._change_seq,
                       "baseline": baseline, "after": SLOWindow(),
                       "began_ts": now}
        self._last_change_ts = now
        self._pressure_since = self._idle_since = None
        self._m_changes.labels(action=action).inc()
        self.transitions.append(dict(detail, ts=round(now, 6),
                                     action=action))
        self._metrics.event("route_elastic_" + action, **detail)

    # -- grading (the canary's verdict over a topology change) ----------

    def _maybe_grade(self, router, now):
        g = self._grade
        if g["after"].n < self.window:
            return
        base, after = g["baseline"], g["after"]
        breaches = slo_breaches(after, base, self.ttft_x,
                                self.min_delta_s, self.goodput_drop)
        evidence = {
            "action": g["action"], "replica": g["replica"],
            "change_id": g["change_id"], "window": self.window,
            "baseline_n": base.n, "after_n": after.n,
            "ttft_p99_after": after.ttft_p99(),
            "ttft_p99_baseline": base.ttft_p99(),
            "intertoken_p99_after": after.intertoken_p99(),
            "intertoken_p99_baseline": base.intertoken_p99(),
            "goodput_ratio_after": round(after.goodput_ratio(), 4),
            "goodput_ratio_baseline": round(base.goodput_ratio(), 4),
            "ttft_x": self.ttft_x, "min_delta_s": self.min_delta_s,
            "goodput_drop": self.goodput_drop, "breaches": breaches,
            "elapsed_s": round(now - g["began_ts"], 3),
        }
        self._grade = None
        self.state = "steady"
        if breaches and g["action"] == "scale_down":
            # the scale-down made the SLO worse: roll it back by
            # re-spawning what was drained, exactly like a weight
            # rollout rolls back to the previous build
            if self._spawn is not None:
                router.note_spawn_pending()
                evidence["respawned"] = self._spawn(router)
            self._last_change_ts = now  # a rollback is itself a change
            self._m_changes.labels(action="rollback").inc()
            self.decisions.append(("rollback", evidence))
            self.transitions.append({"ts": round(now, 6),
                                     "action": "rollback",
                                     "change_id": g["change_id"],
                                     "breaches": breaches})
            self._metrics.event("route_elastic_rollback", **evidence)
        else:
            self.decisions.append(("promote", evidence))
            self.transitions.append({"ts": round(now, 6),
                                     "action": "promote",
                                     "change_id": g["change_id"],
                                     "breaches": breaches})
            self._metrics.event("route_elastic_promote", **evidence)
