"""The router: N serve replicas behind ONE admission point, the port of
``horovod_tpu/router/core.py``.

Clients talk to the ``Router``; it scores every live replica's load
snapshot (queue depth, active slots, free KV blocks, generations) and
dispatches to the winner, with cache-affinity stickiness on top
(policy.py). Each ``step()`` drives every live engine one scheduler
iteration and hands back their results stamped with the replica that
served them.

Replica loss is the router's second job: when the control plane declares
a replica dead (``RanksLostError`` through each engine's
``on_ranks_lost`` callback, wired to ``on_ranks_lost()`` here), the router
requeues that replica's unfinished requests to survivors (fresh Request
objects, fresh traces, results stamped ``rerouted``), bounded by
``HVD_ROUTE_REROUTE_WINDOW_S`` so a stale request fails loudly instead of
resurrecting. Exactly once by construction: the assignment ledger entry
is popped before the re-dispatch, so a second loss event can never
duplicate work, only reroute again what is still unfinished.

The elasticity plane adds three more concerns:

  * graceful drain: ``begin_drain`` walks a replica live -> DRAINING ->
    RETIRED. A draining replica gets no dispatches and no affinity pins
    but keeps stepping until its in-flight work finishes, bounded by
    ``HVD_ELASTIC_DRAIN_TIMEOUT_S``; past the bound the remainder
    reroutes through the same exactly-once ledger path as an unplanned
    loss. ``add_replica`` is the inverse edge (scale-up) and absorbs any
    reroutes parked against a spawn still in flight when their replica
    died.
  * overload shedding: when every dispatchable replica is saturated
    (KV-exhausted, or queue depth past ``HVD_ELASTIC_SHED_DEPTH``),
    ``submit`` rejects AT ADMISSION with a retry-after hint derived from
    the observed completion rate (``route_shed`` event,
    ``hvd_route_shed_total``).
  * staleness and circuit breaking: a replica whose load snapshot is
    older than ``HVD_ROUTE_STALE_S`` is excluded from dispatch (policy.py
    scores an unreported replica 0, the MOST attractive) and reported to
    the optional ``CircuitBreaker``, which also sees dispatch rejections
    and wedged in-flight requests and steers probe traffic at open
    replicas (elastic.py).

The optional ``canary`` (canary.py) restricts dispatch candidates per the
rollout state before the policy sees them; scoring, affinity and reroute
are the same on both cohorts. The optional ``elastic``
(ElasticityController) observes every terminal result and ticks after the
engines step.
"""

import collections
import time

from ..common import config
from ..serving import tracing as serve_tracing
from ..serving.queue import Request, RequestResult
from ..utils import alerts as hvd_alerts
from ..utils import history as hvd_history
from ..utils import metrics as hvd_metrics
from ..utils import tracing as hvd_tracing
from . import policy as route_policy


class _Assigned:
    """Ledger row: where one admitted request currently lives."""

    __slots__ = ("replica", "request", "assigned_ts", "rerouted",
                 "attempts")

    def __init__(self, replica, request, assigned_ts, rerouted=False,
                 attempts=0):
        self.replica = replica
        self.request = request
        self.assigned_ts = assigned_ts
        self.rerouted = rerouted
        self.attempts = attempts


class ReplicaHandle:
    """One fronted engine. ``replica_id`` doubles as the control-plane
    rank when the engine rides a ReplicaGroup: the heartbeat load
    ledger and RanksLostError rank lists are both keyed by it.

    ``state`` is the replica lifecycle: LIVE -> DRAINING -> RETIRED is
    the planned scale-down path, LIVE -> LOST the
    unplanned one. ``live`` stays a bool view of it so the loss path
    (``handle.live = False``) reads as before."""

    __slots__ = ("replica_id", "engine", "state")

    LIVE = "live"
    DRAINING = "draining"
    RETIRED = "retired"
    LOST = "lost"

    def __init__(self, replica_id, engine):
        self.replica_id = int(replica_id)
        self.engine = engine
        self.state = self.LIVE

    @property
    def live(self):
        return self.state == self.LIVE

    @live.setter
    def live(self, value):
        self.state = self.LIVE if value else self.LOST


class Router:
    """Dispatch + liveness + reroute + elasticity over ServeEngines.

    ``replicas`` is {replica_id: engine} (or an iterable of
    ReplicaHandle). ``policy`` is a policy object, a name, or None for
    ``HVD_ROUTE_POLICY``. ``group`` (the rank-0 ReplicaGroup, optional)
    adds the coordinator's heartbeat load ledger to ``loads()`` so
    heartbeat-only peers show up too. ``canary`` is a
    CanaryController; construct the engines with ``swap_gate=
    canary.gate(replica_id)`` so the controller also holds baseline
    replicas on the old weights while the canary cohort runs ahead.
    ``elastic`` (ElasticityController) and ``breaker``
    (CircuitBreaker) are the elasticity plane's two optional hooks
    (router/elastic.py).
    """

    def __init__(self, replicas, policy=None, canary=None, group=None,
                 affinity_prefix=None, reroute_window_s=None,
                 elastic=None, breaker=None, stale_s=None,
                 drain_timeout_s=None, shed_depth=None,
                 clock=time.monotonic):
        self._handles = {}
        for item in (replicas.items() if hasattr(replicas, "items")
                     else replicas):
            handle = (item if isinstance(item, ReplicaHandle)
                      else ReplicaHandle(*item))
            self._handles[handle.replica_id] = handle
        if not self._handles:
            raise ValueError("Router needs at least one replica")
        self._policy = (policy if hasattr(policy, "choose")
                        else route_policy.resolve(policy))
        self.canary = canary
        self.elastic = elastic
        self.breaker = breaker
        self._group = group
        self._affinity_k = (
            config.env_int("ROUTE_AFFINITY_PREFIX", 8)
            if affinity_prefix is None else int(affinity_prefix))
        self._reroute_window_s = (
            config.env_float("ROUTE_REROUTE_WINDOW_S", 30.0)
            if reroute_window_s is None else float(reroute_window_s))
        self._stale_s = (config.env_float("ROUTE_STALE_S", 5.0)
                         if stale_s is None else float(stale_s))
        self._drain_timeout_s = (
            config.env_float("ELASTIC_DRAIN_TIMEOUT_S", 30.0)
            if drain_timeout_s is None else float(drain_timeout_s))
        self._shed_depth = (config.env_int("ELASTIC_SHED_DEPTH", 16)
                            if shed_depth is None else int(shed_depth))
        self._clock = clock
        self._sticky = {}    # affinity prefix key -> replica_id
        self._inflight = {}  # request_id -> _Assigned
        self._pending_results = []  # loss-path failures, drained by step
        self._draining = {}  # replica_id -> (began_ts, deadline)
        self._parked = []    # orphan _Assigned awaiting a pending spawn
        self._spawn_pending = 0
        now = self._clock()
        self._first_seen = {rid: now for rid in self._handles}
        # recent completion timestamps -> the fleet drain rate that
        # prices the shed path's retry-after hint
        self._completions = collections.deque(maxlen=64)
        self.last_shed = None  # evidence of the most recent shed
        reg = self._metrics = hvd_metrics.get_registry()
        self._m_requests = reg.counter(
            "hvd_route_requests_total",
            "Requests the router dispatched, by destination replica.",
            labels=("replica",))
        self._m_rerouted = reg.counter(
            "hvd_route_rerouted_total",
            "Requests re-dispatched to a survivor after their replica "
            "was declared lost.")
        self._m_affinity = reg.counter(
            "hvd_route_affinity_total",
            "Cache-affinity stickiness outcomes per dispatch: hit "
            "(sticky replica won), miss (first sighting of the "
            "prefix), overflow (sticky replica too loaded — policy "
            "pick won).", labels=("outcome",))
        self._m_live = reg.gauge(
            "hvd_route_replicas_live",
            "Replicas the router currently dispatches to.")
        self._m_shed = reg.counter(
            "hvd_route_shed_total",
            "Requests rejected at admission because every dispatchable "
            "replica was saturated, by the saturation reason.",
            labels=("reason",))
        self._m_draining = reg.gauge(
            "hvd_route_replicas_draining",
            "Replicas currently draining toward planned retirement.")
        self._m_live.set(len(self.live_replicas()))

    # -- live state ----------------------------------------------------

    def live_replicas(self):
        return sorted(r for r, h in self._handles.items() if h.live)

    def loads(self):
        """Per-replica load snapshots: the coordinator's heartbeat
        ledger (covers heartbeat-only peers) overlaid with each local
        engine's own snapshot (always current for fronted engines).
        Every snapshot carries a ``ts`` freshness stamp on this
        router's clock — heartbeat entries keep their coordinator
        receipt stamp, local engine reads are stamped now — which is
        what the staleness exclusion compares against."""
        now = self._clock()
        out = {}
        if self._group is not None:
            out.update(self._group.peer_loads())
        for rid, h in self._handles.items():
            if h.live:
                snap = dict(h.engine.load_snapshot())
                snap.setdefault("ts", now)
                out[rid] = snap
        return out

    @property
    def inflight(self):
        """request_id -> replica_id of every dispatched, unfinished
        request (the reroute ledger, exposed for drills/tests)."""
        return {rid: a.replica for rid, a in self._inflight.items()}

    # -- dispatch ------------------------------------------------------

    def submit(self, request):
        """Route one request to a live replica; returns whether it was
        admitted. False means it was shed at admission (``last_shed``
        carries the retry-after evidence), the chosen replica's queue
        rejected it (already counted and evented by that queue), or no
        replica was dispatchable."""
        now = self._clock()
        loads = self.loads()
        candidates = self.live_replicas()
        if self.canary is not None:
            candidates = self.canary.filter(request.request_id,
                                            candidates, loads)
        candidates, probe = self._usable(candidates, loads, now)
        if not candidates and probe is None:
            self._metrics.event("route_no_replica",
                                request_id=request.request_id)
            return False
        if probe is not None:
            # an open breaker's probe window fired: this request IS the
            # probe — success half-opens the breaker, failure re-arms it
            self.breaker.mark_probe(probe)
            pick, how = probe, "probe"
        else:
            shed = self._should_shed(candidates, loads, now)
            if shed is not None:
                return self._shed(request, *shed)
            pick, how = self._choose(request, candidates, loads)
        admitted = self._dispatch(pick, request, how=how)
        if not admitted and self.breaker is not None:
            self.breaker.record_failure(pick, reason="submit_rejected")
        return admitted

    def _usable(self, candidates, loads, now):
        """Liveness beyond the handle flag: drop candidates whose load
        snapshot is stale (silent heartbeat — policy.py would score
        them 0, i.e. most attractive) and candidates whose circuit
        breaker is open. Both exclusions fall back to the widest
        non-empty set — availability beats discipline — and an open
        breaker whose probe timer fired is returned separately as the
        forced pick for probe traffic."""
        fresh = []
        for rid in candidates:
            snap = loads.get(rid)
            if self._stale_s > 0:
                if snap is None:
                    # never reported: routable only within the grace
                    # window after it was added (brand-new replicas
                    # must be dispatchable before their first
                    # heartbeat; forever-silent ones must not be)
                    if now - self._first_seen.get(rid, now) > \
                            self._stale_s:
                        if self.breaker is not None:
                            self.breaker.note_stale(rid)
                        continue
                elif now - snap.get("ts", now) > self._stale_s:
                    if self.breaker is not None:
                        self.breaker.note_stale(rid)
                    continue
            fresh.append(rid)
        if not fresh:
            fresh = list(candidates)
        probe = None
        if self.breaker is not None:
            allowed, probe = self.breaker.filter(fresh)
            if allowed:
                fresh = allowed
            elif probe is not None:
                fresh = []
            # else: every breaker open and no probe due yet —
            # availability beats isolation, keep dispatching
        return fresh, probe

    # -- overload shedding ---------------------------------------------

    def _should_shed(self, candidates, loads, now):
        """None = someone has headroom. Otherwise (reason,
        retry_after_s): every candidate is saturated — out of KV
        blocks, forecast to stay out (the memory plane's OOM forecast,
        the queued backlog's block claim exceeds the
        WHOLE pool, so even a full drain of the active slots leaves
        the cache short — a merely-negative ``predicted_free_blocks``
        is a drainable backlog, not exhaustion), or queued past
        ``HVD_ELASTIC_SHED_DEPTH`` — so admission would only park the
        request behind a backlog it cannot beat."""
        if self._shed_depth <= 0 or not candidates:
            return None
        reasons = []
        for rid in candidates:
            snap = loads.get(rid) or {}
            free_blocks = snap.get("free_blocks")
            predicted = snap.get("predicted_free_blocks")
            total = snap.get("total_blocks")
            if free_blocks is not None and free_blocks <= 0:
                reasons.append("kv_exhausted")
            elif (predicted is not None and total is not None
                  and free_blocks is not None
                  and predicted <= free_blocks - total):
                # queued claims >= total_blocks: backlog outgrows the
                # pool itself, not just the currently-free slice
                reasons.append("kv_forecast")
            elif (snap.get("queue_depth") or 0) >= self._shed_depth:
                reasons.append("queue_depth")
            else:
                return None
        if all(r == "kv_exhausted" for r in reasons):
            reason = "kv_exhausted"
        elif all(r in ("kv_exhausted", "kv_forecast") for r in reasons):
            reason = "kv_forecast"
        else:
            reason = "queue_depth"
        return reason, self._retry_after(candidates, loads, now)

    def _retry_after(self, candidates, loads, now):
        """Hint derived from the observed fleet drain rate: about how
        long until the least-backlogged candidate makes one admission
        of progress. Floors at 50ms, 1s when nothing has completed yet
        (no rate to price from), caps at 60s."""
        if len(self._completions) < 2:
            return 1.0
        span = now - self._completions[0]
        if span <= 0:
            return 0.05
        rate = len(self._completions) / span
        depth = min((loads.get(r) or {}).get("queue_depth") or 0
                    for r in candidates)
        return round(min(max((depth + 1) / rate, 0.05), 60.0), 3)

    def _shed(self, request, reason, retry_after_s):
        self.last_shed = {"request_id": request.request_id,
                          "reason": reason,
                          "retry_after_s": retry_after_s}
        self._m_shed.labels(reason=reason).inc()
        self._metrics.event("route_shed", request_id=request.request_id,
                            reason=reason, retry_after_s=retry_after_s)
        return False

    def _choose(self, request, candidates, loads):
        """Affinity-over-policy: the sticky replica wins while its cost
        is within AFFINITY_SLACK of the policy's pick; otherwise the
        policy pick wins and the prefix re-pins to it."""
        pick = self._policy.choose(candidates, loads)
        key = route_policy.prefix_key(request.prompt, self._affinity_k)
        if key is None:
            return pick, "policy"
        sticky = self._sticky.get(key)
        if sticky is not None and sticky in candidates:
            gap = (route_policy.score(loads.get(sticky)) -
                   route_policy.score(loads.get(pick)))
            if gap <= route_policy.AFFINITY_SLACK:
                self._m_affinity.labels(outcome="hit").inc()
                return sticky, "affinity"
            self._m_affinity.labels(outcome="overflow").inc()
        else:
            self._m_affinity.labels(outcome="miss").inc()
        self._sticky[key] = pick
        return pick, "policy"

    def _dispatch(self, rid, request, how, rerouted=False, attempts=0):
        if not self._handles[rid].engine.submit(request):
            return False
        self._inflight[request.request_id] = _Assigned(
            rid, request, self._clock(), rerouted=rerouted,
            attempts=attempts)
        self._m_requests.labels(replica=str(rid)).inc()
        trace = serve_tracing.trace_of(request)
        trace.annotate(replica=rid, rerouted=rerouted)
        serve_tracing.route_span(
            tensor=request.request_id, trace_id=trace.trace_id,
            parent=getattr(trace, "root", None), replica=rid,
            policy=self._policy.name, how=how,
            rerouted=rerouted).close()
        return True

    # -- the step loop -------------------------------------------------

    def step(self):
        """One scheduler iteration on every live or draining engine.
        Returns the RequestResults that finished, stamped with the
        replica that served them and the rerouted flag. The canary
        ticks BEFORE the engines step: a newly armed generation must
        be claimed by the controller (cohort chosen, gates closed)
        before any engine's same-step swap poll could take it —
        tick-after-step would let the whole fleet self-swap through a
        still-idle gate. The elasticity controller ticks AFTER: its
        decisions read the post-step fleet state."""
        if self.canary is not None:
            self.canary.tick(self.loads())
        done, self._pending_results = self._pending_results, []
        for rid in sorted(self._handles):
            handle = self._handles[rid]
            if handle.state not in (ReplicaHandle.LIVE,
                                    ReplicaHandle.DRAINING):
                continue  # lost mid-loop by a peer's heartbeat
            for res in handle.engine.step():
                done.append(self._stamp(rid, res))
        now = self._clock()
        self._tick_drains(now)
        self._expire_parked(now)
        self._check_wedged(now)
        if self.elastic is not None:
            self.elastic.tick(self, self.loads(), now)
        # The alert plane rides the router tick as well: in a routed
        # fleet the router's clock is the one that sees breaker trips and
        # fleet-level burn, and engines may tick rarely once drained.
        hvd_history.poke(now)
        hvd_alerts.tick(now)
        return done

    def run_to_completion(self, max_steps=100000):
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.pending():
                break
        return out

    def pending(self):
        if self._inflight or self._pending_results or self._parked:
            return True
        return any(h.engine.active_count or len(h.engine.queue)
                   for h in self._handles.values()
                   if h.state in (ReplicaHandle.LIVE,
                                  ReplicaHandle.DRAINING))

    def _stamp(self, rid, res):
        asg = self._inflight.pop(res.request_id, None)
        res.replica = rid
        if asg is not None and asg.rerouted:
            res.rerouted = True
        self._completions.append(self._clock())
        if self.breaker is not None and res.outcome == "completed":
            self.breaker.record_success(rid)
        if self.canary is not None:
            self.canary.observe(res, rid)
        if self.elastic is not None:
            self.elastic.observe(res)
        return res

    def _check_wedged(self, now):
        """Feed the breaker's wedge signal: a live replica whose OLDEST
        in-flight dispatch is older than the breaker timeout heartbeats
        fine but does not finish work — sick-but-alive."""
        if self.breaker is None or self.breaker.timeout_s <= 0:
            return
        oldest = {}
        for a in self._inflight.values():
            ts = oldest.get(a.replica)
            if ts is None or a.assigned_ts < ts:
                oldest[a.replica] = a.assigned_ts
        for rid, ts in oldest.items():
            handle = self._handles.get(rid)
            if (handle is not None and handle.live and
                    now - ts > self.breaker.timeout_s):
                self.breaker.note_wedged(rid, now - ts)

    # -- graceful drain (planned scale-down) ---------------------------

    def begin_drain(self, replica_id, timeout_s=None):
        """Walk one replica LIVE -> DRAINING: no new dispatches, no
        affinity pins, but its engine keeps stepping until in-flight
        and queued work finishes (zero lost requests), bounded by
        ``timeout_s`` (default ``HVD_ELASTIC_DRAIN_TIMEOUT_S``); past
        the bound the remainder reroutes through the exactly-once
        ledger path. Returns False when the replica is not LIVE."""
        rid = int(replica_id)
        handle = self._handles.get(rid)
        if handle is None or handle.state != ReplicaHandle.LIVE:
            return False
        now = self._clock()
        timeout = (self._drain_timeout_s if timeout_s is None
                   else float(timeout_s))
        handle.state = ReplicaHandle.DRAINING
        if hasattr(handle.engine, "begin_drain"):
            handle.engine.begin_drain()
        self._sticky = {k: v for k, v in self._sticky.items()
                        if v != rid}
        self._draining[rid] = (now, now + timeout)
        self._metrics.event(
            "route_drain_begin", replica=rid, timeout_s=timeout,
            inflight=sorted(a.request.request_id
                            for a in self._inflight.values()
                            if a.replica == rid),
            queued=len(handle.engine.queue))
        self._m_live.set(len(self.live_replicas()))
        self._m_draining.set(len(self._draining))
        return True

    def _tick_drains(self, now):
        for rid, (began, deadline) in list(self._draining.items()):
            handle = self._handles[rid]
            engine = handle.engine
            owed = [a for a in self._inflight.values()
                    if a.replica == rid]
            busy = engine.active_count or len(engine.queue)
            if not busy and not owed:
                self._retire_drained(rid, handle, began, now)
            elif now >= deadline:
                self._retire_drained(rid, handle, began, now, owed=owed)

    def _retire_drained(self, rid, handle, began, now, owed=None):
        """The drain's exit edge. On timeout (``owed`` given) the
        engine stops being stepped BEFORE its remaining requests are
        rerouted — popping the ledger rows first means a late
        completion from the retired engine can never double-deliver."""
        del self._draining[rid]
        handle.state = ReplicaHandle.RETIRED
        hvd_tracing.get_tracer().dump("route_drain")
        if owed:
            rerouted = []
            for asg in owed:
                self._inflight.pop(asg.request.request_id, None)
                self._reroute(asg, now)
                rerouted.append(asg.request.request_id)
            self._metrics.event(
                "route_drain_timeout", replica=rid,
                drained_s=round(now - began, 6),
                rerouted=sorted(rerouted))
        else:
            self._metrics.event("route_drain_done", replica=rid,
                                drained_s=round(now - began, 6))
        self._m_draining.set(len(self._draining))

    # -- scale-up ------------------------------------------------------

    def note_spawn_pending(self):
        """A replica spawn is mid-flight: reroutes that find no
        survivor park against it instead of failing ``no_survivors``,
        and are absorbed by ``add_replica`` once it lands."""
        self._spawn_pending += 1

    def add_replica(self, replica_id, engine):
        """Front a new engine (the scale-up edge, also the elastic
        rollback's re-spawn). Replays any parked reroutes into the
        fresh replica — each re-checked against the reroute window at
        this dispatch, not when it was parked."""
        rid = int(replica_id)
        existing = self._handles.get(rid)
        if existing is not None and existing.state in (
                ReplicaHandle.LIVE, ReplicaHandle.DRAINING):
            raise ValueError(f"replica {rid} is already {existing.state}")
        self._handles[rid] = ReplicaHandle(rid, engine)
        now = self._clock()
        self._first_seen[rid] = now
        self._spawn_pending = max(self._spawn_pending - 1, 0)
        self._m_live.set(len(self.live_replicas()))
        self._metrics.event("route_replica_added", replica=rid)
        parked, self._parked = self._parked, []
        for asg in parked:
            self._reroute(asg, now)
        return self._handles[rid]

    def _expire_parked(self, now):
        """A parked reroute whose spawn never lands must still fail
        loudly inside the reroute window, never hang."""
        if not self._parked:
            return
        keep = []
        for asg in self._parked:
            if now - asg.assigned_ts > self._reroute_window_s:
                self._fail(asg, "reroute_window", now)
            else:
                keep.append(asg)
        self._parked = keep

    # -- replica loss + reroute ----------------------------------------

    def on_ranks_lost(self, lost):
        """Wire as every engine's ``on_ranks_lost`` callback. Marks the
        dead replicas, then requeues each one's unfinished requests to
        survivors (exactly-once: ledger rows are popped before
        re-dispatch, so repeated loss notifications are idempotent)."""
        now = self._clock()
        for rid in sorted({int(r) for r in lost}):
            handle = self._handles.get(rid)
            if handle is not None:
                handle.live = False
            self._draining.pop(rid, None)
            victims = [a for a in list(self._inflight.values())
                       if a.replica == rid]
            self._metrics.event(
                "route_replica_lost", replica=rid,
                inflight=sorted(a.request.request_id for a in victims))
            for asg in victims:
                self._inflight.pop(asg.request.request_id, None)
                self._reroute(asg, now)
        self._m_live.set(len(self.live_replicas()))
        self._m_draining.set(len(self._draining))

    def _fail(self, asg, reason, now):
        trace = serve_tracing.trace_of(asg.request)
        phases = trace.on_retire("failed", reason)
        self._pending_results.append(RequestResult(
            asg.request.request_id, (), "failed", finish_ts=now,
            reason=reason, trace_id=trace.trace_id,
            phase_ms=phases or None, replica=asg.replica,
            rerouted=asg.rerouted))

    def _reroute(self, asg, now):
        req = asg.request
        waited = now - asg.assigned_ts
        if waited > self._reroute_window_s:
            self._fail(asg, "reroute_window", now)
            return
        survivors = self.live_replicas()
        loads = self.loads()
        if self.canary is not None:
            survivors = self.canary.filter(req.request_id, survivors,
                                           loads)
        if not survivors:
            if self._spawn_pending > 0:
                # a scale-up is mid-flight: park the orphan for the
                # new replica to absorb instead of failing a request
                # that is about to have somewhere to go
                self._parked.append(asg)
                self._metrics.event(
                    "route_reroute_parked",
                    request_id=req.request_id,
                    from_replica=asg.replica)
                return
            self._fail(asg, "no_survivors", now)
            return
        # close the dead attempt's trace, then resubmit a FRESH Request
        # (no trace attr) so the queue mints a new lifecycle — the old
        # spans belong to the lost replica's story, not the retry's
        serve_tracing.trace_of(req).on_retire("failed", "replica_lost")
        retry = Request(
            request_id=req.request_id, prompt=req.prompt,
            max_new_tokens=req.max_new_tokens,
            temperature=req.temperature, deadline_s=req.deadline_s,
            arrival_ts=req.arrival_ts)
        pick, how = self._choose(retry, survivors, loads)
        if not self._dispatch(pick, retry, how=how, rerouted=True,
                              attempts=asg.attempts + 1):
            self._fail(asg, "reroute_rejected", now)
            return
        self._m_rerouted.inc()
        self._metrics.event(
            "route_reroute", request_id=req.request_id,
            from_replica=asg.replica, to_replica=pick,
            attempt=asg.attempts + 1, waited_s=round(waited, 6))
