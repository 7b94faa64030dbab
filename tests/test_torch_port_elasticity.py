"""horovod_tpu_torch's elasticity plane against the JAX package's.

The cases of tests/test_elasticity.py (the ElasticityController's
hysteresis and canary-style grading, the CircuitBreaker's transitions,
the Router's staleness exclusion, overload shedding with its drain-rate
retry-after, graceful drain, scale-up with parked reroutes, and breaker
integration), each one script on a ``FakeEngine``, a ``FakeRouter`` and a
``FakeClock`` that drives both packages. The controller's action
sequence, the breaker's transitions, the sheds and the drains must be
equal, and every ``route_*`` event and ``hvd_route_*`` /
``hvd_elastic_*`` metric with them.

And the cases of tests/test_chaos_plane.py::TestReplicaSupervisorRPC
against the port's replica supervisor door under the same chaos rules: a
spawn whose response is dropped, or a drain delivered twice, executes
once; a delayed drain completes within its bound; distinct change ids
execute apart; a failing hook fails loudly by name; no hook refuses.
"""

import time

import pytest

KEY = b"k" * 32


class Pkg:
    """One package's elasticity-plane surface, by name."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            from horovod_tpu import router
            from horovod_tpu.router import elastic
            from horovod_tpu.serving import queue
            from horovod_tpu.serving.engine import ServeEngine
            from horovod_tpu.utils import metrics
        else:
            from horovod_tpu_torch import router
            from horovod_tpu_torch.router import elastic
            from horovod_tpu_torch.serving import queue
            from horovod_tpu_torch.serving.engine import ServeEngine
            from horovod_tpu_torch.utils import metrics
        self.elastic, self.queue, self.metrics = elastic, queue, metrics
        self.ServeEngine = ServeEngine
        self.Router = router.Router
        self.CircuitBreaker = router.CircuitBreaker
        self.ElasticityController = router.ElasticityController
        self.Request = queue.Request
        self.RequestResult = queue.RequestResult

    def engine(self, **kw):
        return FakeEngine(self, **kw)

    def req(self, i, prompt=None, max_new_tokens=8):
        return self.Request(request_id=f"r{i}",
                            prompt=prompt if prompt is not None
                            else (100 + i, 200 + i, 300 + i),
                            max_new_tokens=max_new_tokens)

    def result(self, i, outcome="completed", ttft_s=0.01,
               tokens=(1, 2, 3)):
        return self.RequestResult(f"g{i}", tuple(tokens), outcome,
                                  ttft_s=ttft_s)

    def ctrl(self, clock, spawn=None, **kw):
        kw.setdefault("min_replicas", 1)
        kw.setdefault("max_replicas", 0)
        kw.setdefault("dwell_s", 5.0)
        kw.setdefault("cooldown_s", 10.0)
        kw.setdefault("ttft_slo_s", 1.0)
        kw.setdefault("up_depth", 4.0)
        kw.setdefault("down_util", 0.25)
        kw.setdefault("window", 4)
        return self.ElasticityController(spawn=spawn, clock=clock, **kw)

    def breaker(self, clock, **kw):
        kw.setdefault("fails", 3)
        kw.setdefault("probe_s", 2.0)
        kw.setdefault("close_n", 2)
        kw.setdefault("timeout_s", 10.0)
        return self.CircuitBreaker(clock=clock, **kw)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class FakeEngine:
    """ServeEngine stand-in (the surface tests/test_router.py uses)."""

    def __init__(self, pkg, accept=True, generation=1):
        self.pkg = pkg
        self.accept = accept
        self.generation = generation
        self.queue = []
        self.held = {}
        self.load = None
        self._done = []

    def submit(self, request):
        if not self.accept:
            return False
        self.held[request.request_id] = request
        return True

    @property
    def active_count(self):
        return len(self.held)

    def load_snapshot(self):
        if self.load is not None:
            return dict(self.load)
        return {"queue_depth": 0, "active_slots": len(self.held),
                "work_tokens": sum(r.max_new_tokens
                                   for r in self.held.values()),
                "free_slots": 8 - len(self.held), "free_blocks": 8,
                "generation": self.generation,
                "armed_generation": None}

    def finish(self, request_id, tokens=(5, 6, 7), ttft_s=0.01):
        req = self.held.pop(request_id)
        self._done.append(self.pkg.RequestResult(
            req.request_id, tuple(tokens), "completed", ttft_s=ttft_s,
            generation=self.generation))

    def step(self):
        out, self._done = self._done, []
        return out


class FakeRouter:
    """Just enough router surface for controller-only cases."""

    def __init__(self, live=(0,)):
        self.live = list(live)
        self.spawns_pending = 0
        self.drained = []

    def live_replicas(self):
        return sorted(self.live)

    def note_spawn_pending(self):
        self.spawns_pending += 1

    def begin_drain(self, rid):
        if rid not in self.live:
            return False
        self.live.remove(rid)
        self.drained.append(rid)
        return True


PRESSURE = {"queue_depth": 10, "active_slots": 8, "free_slots": 0,
            "free_blocks": 4}
IDLE = {"queue_depth": 0, "active_slots": 0, "free_slots": 8,
        "free_blocks": 8}


def _value(snap, name, **labels):
    fam = snap["metrics"].get(name)
    if fam is None:
        return None
    for v in fam["values"]:
        if all(v["labels"].get(k) == lv for k, lv in labels.items()):
            return v.get("value", v.get("count"))
    return None


def _events(snap, kind):
    return [{k: v for k, v in e.items() if k not in ("ts_us", "epoch_us")}
            for e in snap["events"] if e["event"] == kind]


def _results(results):
    return [(r.request_id, r.outcome, r.reason, r.replica, r.rerouted)
            for r in results]


def _both(scenario):
    """``scenario(pkg)`` for each package with a fresh registry; asserts
    equal records, ``route_*`` events and ``hvd_route_*`` /
    ``hvd_elastic_*`` metrics, and returns the port's record and
    snapshot."""
    out = {}
    for name in ("jax", "torch"):
        pkg = Pkg(name)
        reg = pkg.metrics.reset(enabled=True)
        try:
            rec = scenario(pkg)
            snap = reg.snapshot()
            events = [{k: v for k, v in e.items()
                       if k not in ("ts_us", "epoch_us")}
                      for e in snap["events"]
                      if e["event"].startswith("route_")]
            fams = {n: sorted((sorted(v["labels"].items()),
                               v.get("value", v.get("count")))
                              for v in f["values"])
                    for n, f in snap["metrics"].items()
                    if n.startswith(("hvd_route_", "hvd_elastic_"))}
            out[name] = (rec, events, fams, snap)
        finally:
            pkg.metrics.reset()
    assert out["torch"][:3] == out["jax"][:3]
    return out["torch"][0], out["torch"][3]


def _ctrl_record(ctrl, rt=None):
    rec = {"state": ctrl.state, "decisions": ctrl.decisions,
           "transitions": ctrl.transitions}
    if rt is not None:
        rec.update(spawns=rt.spawns_pending, drained=list(rt.drained))
    return rec


# ---------------------------------------------------------------------------
# ElasticityController: hysteresis
# ---------------------------------------------------------------------------

class TestElasticHysteresis:
    def test_pressure_must_dwell_before_scale_up(self):
        def scenario(pkg):
            clock = FakeClock()
            spawned = []
            rt = FakeRouter([0])
            ctrl = pkg.ctrl(clock, spawn=lambda r: spawned.append(1) or 7)
            seen = []
            for t in (0.0, 4.9, 5.0):
                clock.t = t
                ctrl.tick(rt, {0: dict(PRESSURE)}, clock.t)
                seen.append(len(spawned))
            return seen, _ctrl_record(ctrl, rt)
        (seen, rec), snap = _both(scenario)
        assert seen == [0, 0, 1] and rec["spawns"] == 1
        assert _value(snap, "hvd_elastic_changes_total",
                      action="scale_up") == 1
        (ev,) = _events(snap, "route_elastic_scale_up")
        assert ev["queue_depth"] == 10 and ev["replica"] == 7

    def test_pressure_blip_resets_the_dwell(self):
        def scenario(pkg):
            clock = FakeClock()
            spawned = []
            rt = FakeRouter([0])
            ctrl = pkg.ctrl(clock, spawn=lambda r: spawned.append(1) or 7)
            seen = []
            for t, load in ((0.0, PRESSURE), (3.0, dict(IDLE, queue_depth=1)),
                            (6.0, PRESSURE), (11.0, PRESSURE)):
                clock.t = t
                ctrl.tick(rt, {0: dict(load)}, clock.t)
                seen.append(len(spawned))
            return seen
        assert _both(scenario)[0] == [0, 0, 0, 1]

    def test_cooldown_gates_the_next_change(self):
        def scenario(pkg):
            clock = FakeClock()
            rt = FakeRouter([0])
            ctrl = pkg.ctrl(clock, spawn=lambda r: 7, window=1)
            clock.t = 5.0
            ctrl.tick(rt, {0: dict(PRESSURE)}, 0.0)
            ctrl.tick(rt, {0: dict(PRESSURE)}, clock.t)
            seen = [rt.spawns_pending]
            ctrl.observe(pkg.result(1))
            ctrl._maybe_grade(rt, clock.t)
            seen.append(ctrl.state)
            for t in (6.0, 10.0, 14.9, 20.0):
                clock.t = t
                ctrl.tick(rt, {0: dict(PRESSURE)}, t)
                seen.append(rt.spawns_pending)
            return seen, _ctrl_record(ctrl, rt)
        (seen, _), _ = _both(scenario)
        assert seen == [1, "steady", 1, 1, 1, 2]

    def test_max_replicas_caps_scale_up(self):
        def scenario(pkg):
            clock = FakeClock(10.0)
            rt = FakeRouter([0, 1])
            ctrl = pkg.ctrl(clock, spawn=lambda r: 7, max_replicas=2)
            loads = {0: dict(PRESSURE), 1: dict(PRESSURE)}
            ctrl.tick(rt, loads, 0.0)
            ctrl.tick(rt, loads, 10.0)
            return rt.spawns_pending
        assert _both(scenario)[0] == 0

    def test_idle_scale_down_drains_cheapest_and_respects_floor(self):
        def scenario(pkg):
            clock = FakeClock()
            rt = FakeRouter([0, 1])
            ctrl = pkg.ctrl(clock, min_replicas=1)
            loads = {0: dict(IDLE, active_slots=1, free_slots=7),
                     1: dict(IDLE)}
            ctrl.tick(rt, loads, 0.0)
            ctrl.tick(rt, loads, 5.0)
            first = list(rt.drained)
            ctrl._grade = None
            ctrl.state = "steady"
            ctrl._last_change_ts = None
            ctrl.tick(rt, {0: dict(IDLE)}, 20.0)
            ctrl.tick(rt, {0: dict(IDLE)}, 30.0)
            return first, list(rt.drained)
        (first, after), snap = _both(scenario)
        assert first == after == [1]
        (ev,) = _events(snap, "route_elastic_scale_down")
        assert ev["replica"] == 1

    def test_kv_starvation_and_ttft_are_pressure(self):
        def scenario(pkg):
            clock = FakeClock()
            rt = FakeRouter([0])
            ctrl = pkg.ctrl(clock, spawn=lambda r: 7)
            starved = dict(IDLE, queue_depth=1, free_blocks=0)
            ctrl.tick(rt, {0: starved}, 0.0)
            ctrl.tick(rt, {0: starved}, 5.0)
            seen = [rt.spawns_pending]
            ctrl2 = pkg.ctrl(clock, spawn=lambda r: 8, ttft_slo_s=0.5)
            for i in range(3):
                ctrl2.observe(pkg.result(i, ttft_s=2.0))
            busy = dict(IDLE, queue_depth=1, active_slots=4, free_slots=4)
            ctrl2.tick(rt, {0: dict(busy)}, 10.0)
            ctrl2.tick(rt, {0: dict(busy)}, 15.0)
            seen.append(rt.spawns_pending)
            return seen
        seen, snap = _both(scenario)
        assert seen == [1, 2]
        assert _events(snap, "route_elastic_scale_up")[0]["kv_starved"]

    def test_pressure_gauge_tracks_the_band(self):
        def scenario(pkg):
            clock = FakeClock()
            rt = FakeRouter([0])
            ctrl = pkg.ctrl(clock)
            reg = pkg.metrics.get_registry()
            out = []
            for t, load in ((0.0, PRESSURE), (1.0, IDLE),
                            (2.0, dict(IDLE, queue_depth=1, active_slots=4,
                                       free_slots=4))):
                ctrl.tick(rt, {0: dict(load)}, t)
                out.append(_value(reg.snapshot(), "hvd_elastic_pressure"))
            return out
        assert _both(scenario)[0] == [1, -1, 0]


# ---------------------------------------------------------------------------
# ElasticityController: canary-style grading
# ---------------------------------------------------------------------------

def _scale_down(clock, rt, ctrl):
    loads = {0: dict(IDLE), 1: dict(IDLE)}
    ctrl.tick(rt, loads, clock.t)
    clock.t += 5.0
    ctrl.tick(rt, loads, clock.t)
    assert rt.drained and ctrl.state == "grading"


class TestElasticGrading:
    def test_benign_scale_down_promotes(self):
        def scenario(pkg):
            clock = FakeClock()
            rt = FakeRouter([0, 1])
            ctrl = pkg.ctrl(clock, spawn=lambda r: 9, window=4)
            for i in range(4):
                ctrl.observe(pkg.result(i))
            _scale_down(clock, rt, ctrl)
            for i in range(4):
                ctrl.observe(pkg.result(10 + i))
            clock.t += 1.0
            ctrl.tick(rt, {0: dict(IDLE, queue_depth=1, active_slots=4,
                                   free_slots=4)}, clock.t)
            return _ctrl_record(ctrl, rt)
        rec, snap = _both(scenario)
        assert rec["state"] == "steady" and rec["spawns"] == 0
        verdict, evidence = rec["decisions"][-1]
        assert verdict == "promote" and evidence["breaches"] == []
        assert _events(snap, "route_elastic_promote")

    def test_breached_scale_down_rolls_back_by_respawning(self):
        def scenario(pkg):
            clock = FakeClock()
            rt = FakeRouter([0, 1])
            respawned = []
            ctrl = pkg.ctrl(clock, spawn=lambda r: respawned.append(9) or 9,
                            window=4, ttft_x=1.5, min_delta_s=0.025)
            for i in range(4):
                ctrl.observe(pkg.result(i, ttft_s=0.01))
            _scale_down(clock, rt, ctrl)
            for i in range(4):
                ctrl.observe(pkg.result(10 + i, ttft_s=1.5))
            clock.t += 1.0
            ctrl.tick(rt, {0: dict(IDLE)}, clock.t)
            return respawned, _ctrl_record(ctrl, rt)
        (respawned, rec), snap = _both(scenario)
        assert respawned == [9] and rec["spawns"] == 1
        verdict, evidence = rec["decisions"][-1]
        assert verdict == "rollback" and "ttft_p99" in evidence["breaches"]
        assert evidence["respawned"] == 9
        assert [t["action"] for t in rec["transitions"]] == [
            "scale_down", "rollback"]
        assert _value(snap, "hvd_elastic_changes_total",
                      action="rollback") == 1

    def test_one_change_at_a_time_while_grading(self):
        def scenario(pkg):
            clock = FakeClock()
            rt = FakeRouter([0, 1])
            ctrl = pkg.ctrl(clock, spawn=lambda r: 9, window=4)
            for i in range(4):
                ctrl.observe(pkg.result(i))
            _scale_down(clock, rt, ctrl)
            clock.t += 20.0
            ctrl.tick(rt, {0: dict(PRESSURE)}, clock.t)
            clock.t += 5.0
            ctrl.tick(rt, {0: dict(PRESSURE)}, clock.t)
            return rt.spawns_pending
        assert _both(scenario)[0] == 0

    def test_baseline_freezes_before_the_change(self):
        def scenario(pkg):
            clock = FakeClock()
            rt = FakeRouter([0, 1])
            ctrl = pkg.ctrl(clock, window=4)
            for i in range(4):
                ctrl.observe(pkg.result(i, ttft_s=0.01))
            _scale_down(clock, rt, ctrl)
            base = ctrl._grade["baseline"]
            n_before = base.n
            ctrl.observe(pkg.result(99, ttft_s=9.0))
            return n_before, base.n, ctrl._grade["after"].n
        n0, n1, after = _both(scenario)[0]
        assert n0 == n1 and after == 1


# ---------------------------------------------------------------------------
# CircuitBreaker
# ---------------------------------------------------------------------------

class TestCircuitBreaker:
    def test_consecutive_failures_trip_open(self):
        def scenario(pkg):
            br = pkg.breaker(FakeClock())
            seen = []
            for _ in range(3):
                br.record_failure(0)
                seen.append(br.state(0))
            return seen, br.filter([0, 1])
        (seen, filt), snap = _both(scenario)
        assert seen == ["closed", "closed", "open"]
        assert filt == ([1], None)
        assert _value(snap, "hvd_route_breaker_trips_total",
                      reason="dispatch_failed") == 1

    def test_success_resets_the_failure_streak(self):
        def scenario(pkg):
            br = pkg.breaker(FakeClock())
            for ok in (False, False, True, False, False):
                (br.record_success if ok else br.record_failure)(0)
            return br.state(0)
        assert _both(scenario)[0] == "closed"

    def test_probe_halfopen_close_cycle(self):
        def scenario(pkg):
            clock = FakeClock()
            br = pkg.breaker(clock)
            for _ in range(3):
                br.record_failure(0)
            clock.t = 1.0
            seen = [br.filter([0])]
            clock.t = 2.5
            seen.append(br.filter([0]))
            br.mark_probe(0)
            seen.append(br.filter([0]))
            br.record_success(0)
            seen.append(br.state(0))
            br.record_success(0)
            seen.append(br.state(0))
            return seen
        seen, snap = _both(scenario)
        assert seen == [([], None), ([], 0), ([], None), "half_open",
                        "closed"]
        assert [e["state"] for e in _events(snap, "route_breaker")] == [
            "open", "half_open", "closed"]

    def test_halfopen_failure_retrips(self):
        def scenario(pkg):
            clock = FakeClock()
            br = pkg.breaker(clock)
            for _ in range(3):
                br.record_failure(0)
            clock.t = 2.5
            br.filter([0])
            br.mark_probe(0)
            br.record_success(0)
            mid = br.state(0)
            br.record_failure(0)
            return mid, br.state(0)
        (mid, end), snap = _both(scenario)
        assert (mid, end) == ("half_open", "open")
        assert _value(snap, "hvd_route_breaker_trips_total",
                      reason="half_open_dispatch_failed") == 1

    def test_stale_and_wedged_trip_immediately(self):
        def scenario(pkg):
            br = pkg.breaker(FakeClock())
            br.note_stale(3)
            br.note_wedged(4, age_s=12.5)
            return br.state(3), br.state(4)
        states, snap = _both(scenario)
        assert states == ("open", "open")
        wedge = [e for e in _events(snap, "route_breaker")
                 if e["reason"] == "wedged"]
        assert wedge[0]["age_s"] == 12.5


# ---------------------------------------------------------------------------
# Router: staleness exclusion, shedding, drain, scale-up, breakers
# ---------------------------------------------------------------------------

class TestStaleExclusion:
    def test_silent_replica_no_longer_absorbs_all_traffic(self):
        def scenario(pkg):
            busy, silent = pkg.engine(), pkg.engine()
            busy.load = {"queue_depth": 6, "active_slots": 8,
                         "free_slots": 0, "free_blocks": 8}
            silent.load = {"queue_depth": 0, "active_slots": 0,
                           "free_slots": 8, "free_blocks": 8, "ts": 0.0}
            router = pkg.Router({0: busy, 1: silent}, policy="least_loaded",
                                stale_s=5.0, shed_depth=0,
                                clock=FakeClock(10.0))
            return router.submit(pkg.req(1)), router.inflight
        assert _both(scenario)[0] == (True, {"r1": 0})

    def test_stale_exclusion_feeds_the_breaker(self):
        def scenario(pkg):
            clock = FakeClock(10.0)
            busy, silent = pkg.engine(), pkg.engine()
            silent.load = {"queue_depth": 0, "ts": 0.0}
            br = pkg.CircuitBreaker(fails=3, probe_s=60.0, clock=clock)
            router = pkg.Router({0: busy, 1: silent}, breaker=br,
                                stale_s=5.0, shed_depth=0, clock=clock)
            router.submit(pkg.req(1))
            return br.state(1)
        assert _both(scenario)[0] == "open"

    def test_all_stale_falls_back_and_zero_disables(self):
        def scenario(pkg):
            clock = FakeClock(10.0)
            a, b = pkg.engine(), pkg.engine()
            a.load = {"queue_depth": 0, "ts": 0.0}
            b.load = {"queue_depth": 0, "ts": 0.0}
            router = pkg.Router({0: a, 1: b}, stale_s=5.0, shed_depth=0,
                                clock=clock)
            out = [router.submit(pkg.req(1))]
            eng = pkg.engine()
            eng.load = {"queue_depth": 0, "ts": 0.0}
            router = pkg.Router({0: eng}, stale_s=0.0, shed_depth=0,
                                clock=clock)
            out += [router.submit(pkg.req(2)), router.inflight]
            return out
        assert _both(scenario)[0] == [True, True, {"r2": 0}]

    def test_never_reported_grace_window(self):
        def scenario(pkg):
            router = pkg.Router({0: pkg.engine()}, stale_s=5.0,
                                clock=FakeClock(0.0))
            first = router._usable([0, 7], {0: {"ts": 0.0}}, 0.0)
            router._first_seen[7] = 0.0
            return first, router._usable([0, 7], {0: {"ts": 10.0}}, 10.0)
        assert _both(scenario)[0] == (([0, 7], None), ([0], None))


def _saturated(pkg, depth=8):
    eng = pkg.engine()
    eng.load = {"queue_depth": depth, "active_slots": 8, "free_slots": 0,
                "free_blocks": 4}
    return eng


class TestShedding:
    def test_sheds_when_every_replica_is_deep(self):
        def scenario(pkg):
            router = pkg.Router({0: _saturated(pkg), 1: _saturated(pkg)},
                                shed_depth=4, stale_s=0, clock=FakeClock())
            return router.submit(pkg.req(1)), router.last_shed, \
                router.inflight
        (ok, shed, inflight), snap = _both(scenario)
        assert not ok and not inflight
        assert shed == {"request_id": "r1", "reason": "queue_depth",
                        "retry_after_s": 1.0}
        assert _value(snap, "hvd_route_shed_total",
                      reason="queue_depth") == 1

    def test_kv_exhaustion_and_headroom(self):
        def scenario(pkg):
            eng = pkg.engine()
            eng.load = {"queue_depth": 0, "free_blocks": 0}
            router = pkg.Router({0: eng}, shed_depth=4, stale_s=0,
                                clock=FakeClock())
            out = [router.submit(pkg.req(1)), router.last_shed["reason"]]
            router = pkg.Router({0: _saturated(pkg), 1: pkg.engine()},
                                shed_depth=4, stale_s=0, clock=FakeClock())
            out += [router.submit(pkg.req(2)), router.inflight]
            router = pkg.Router({0: _saturated(pkg)}, shed_depth=0,
                                stale_s=0, clock=FakeClock())
            out.append(router.submit(pkg.req(3)))
            return out
        assert _both(scenario)[0] == [False, "kv_exhausted", True,
                                      {"r2": 1}, True]

    def test_kv_forecast_reason(self):
        def scenario(pkg):
            eng = pkg.engine()
            eng.load = {"queue_depth": 2, "free_blocks": 4,
                        "predicted_free_blocks": -60, "total_blocks": 64}
            router = pkg.Router({0: eng}, shed_depth=4, stale_s=0,
                                clock=FakeClock())
            return router.submit(pkg.req(1)), router.last_shed
        ok, shed = _both(scenario)[0]
        assert not ok and shed["reason"] == "kv_forecast"

    def test_retry_after_prices_from_the_drain_rate(self):
        def scenario(pkg):
            clock = FakeClock()
            eng = pkg.engine()
            router = pkg.Router({0: eng}, shed_depth=4, stale_s=0,
                                clock=clock)
            router.submit(pkg.req(1))
            router.submit(pkg.req(2))
            eng.finish("r1")
            clock.t = 1.0
            router.step()
            eng.finish("r2")
            clock.t = 2.0
            router.step()
            eng.load = {"queue_depth": 7, "active_slots": 8,
                        "free_slots": 0, "free_blocks": 4}
            return router.submit(pkg.req(3)), router.last_shed
        ok, shed = _both(scenario)[0]
        assert not ok and shed["retry_after_s"] == pytest.approx(4.0)


class TestGracefulDrain:
    def test_drain_excludes_dispatch_but_finishes_inflight(self):
        def scenario(pkg):
            clock = FakeClock()
            a, b = pkg.engine(), pkg.engine()
            router = pkg.Router({0: a, 1: b}, stale_s=0, shed_depth=0,
                                clock=clock)
            router.submit(pkg.req(1, prompt=(1, 2, 3)))
            victim = router.inflight["r1"]
            out = [victim, router.begin_drain(victim),
                   router.live_replicas()]
            router.submit(pkg.req(2, prompt=(9, 9, 9)))
            out.append(router.inflight["r2"])
            (a if victim == 0 else b).finish("r1")
            clock.t = 1.0
            out.append(_results(router.step()))
            out.append(router._handles[victim].state)
            return out
        (victim, began, live, r2, results, state), snap = _both(scenario)
        assert began and live == [1 - victim] and r2 == 1 - victim
        assert results == [("r1", "completed", "", victim, False)]
        assert state == "retired"
        (done,) = _events(snap, "route_drain_done")
        assert done["replica"] == victim and done["drained_s"] == 1.0

    def test_drain_timeout_reroutes_via_the_ledger(self):
        def scenario(pkg):
            clock = FakeClock()
            a, b = pkg.engine(), pkg.engine()
            router = pkg.Router({0: a, 1: b}, stale_s=0, shed_depth=0,
                                reroute_window_s=60.0, clock=clock)
            router.submit(pkg.req(1, prompt=(1, 2, 3)))
            victim = router.inflight["r1"]
            wedged, survivor = (a, b) if victim == 0 else (b, a)
            router.begin_drain(victim, timeout_s=5.0)
            clock.t = 6.0
            router.step()
            moved = router.inflight["r1"]
            wedged.finish("r1")
            survivor.finish("r1")
            return victim, moved, _results(router.step())
        (victim, moved, results), snap = _both(scenario)
        assert moved == 1 - victim
        assert results == [("r1", "completed", "", 1 - victim, True)]
        (ev,) = _events(snap, "route_drain_timeout")
        assert ev["rerouted"] == ["r1"] and ev["drained_s"] == 6.0

    def test_reroute_window_expiry_racing_drain(self):
        def scenario(pkg):
            clock = FakeClock()
            router = pkg.Router({0: pkg.engine(), 1: pkg.engine()},
                                stale_s=0, shed_depth=0,
                                reroute_window_s=5.0, clock=clock)
            router.submit(pkg.req(1, prompt=(1, 2, 3)))
            victim = router.inflight["r1"]
            router.begin_drain(victim, timeout_s=10.0)
            clock.t = 11.0
            router.step()
            return _results(router.step()), router.inflight
        (results, inflight), _ = _both(scenario)
        assert [r[:3] for r in results] == [("r1", "failed",
                                             "reroute_window")]
        assert "r1" not in inflight

    def test_begin_drain_rejects_non_live_and_signals_the_engine(self):
        def scenario(pkg):
            router = pkg.Router({0: pkg.engine()}, clock=FakeClock())
            out = [router.begin_drain(0), router.begin_drain(0),
                   router.begin_drain(42)]
            a = pkg.engine()
            a.begin_drain = lambda: setattr(a, "drained", True)
            router = pkg.Router({0: a, 1: pkg.engine()}, clock=FakeClock())
            router.begin_drain(0)
            out.append(getattr(a, "drained", False))
            out.append(hasattr(pkg.ServeEngine, "begin_drain"))
            return out
        assert _both(scenario)[0] == [True, False, False, True, True]


class TestScaleUpAndParked:
    def test_reroute_parks_against_pending_spawn(self):
        def scenario(pkg):
            clock = FakeClock()
            router = pkg.Router({0: pkg.engine()}, stale_s=0, shed_depth=0,
                                reroute_window_s=30.0, clock=clock)
            router.submit(pkg.req(1, prompt=(1, 2, 3)))
            router.note_spawn_pending()
            router.on_ranks_lost([0])
            out = [_results(router.step())]
            fresh = pkg.engine()
            clock.t = 1.0
            router.add_replica(1, fresh)
            out.append(router.inflight)
            fresh.finish("r1")
            out.append(_results(router.step()))
            return out
        (parked, inflight, results), snap = _both(scenario)
        assert parked == [] and inflight == {"r1": 1}
        assert results == [("r1", "completed", "", 1, True)]
        (ev,) = _events(snap, "route_reroute_parked")
        assert ev["request_id"] == "r1" and ev["from_replica"] == 0

    def test_parked_reroute_expires_inside_the_window(self):
        def scenario(pkg):
            clock = FakeClock()
            router = pkg.Router({0: pkg.engine()}, stale_s=0, shed_depth=0,
                                reroute_window_s=5.0, clock=clock)
            router.submit(pkg.req(1, prompt=(1, 2, 3)))
            router.note_spawn_pending()
            router.on_ranks_lost([0])
            clock.t = 6.0
            router.step()
            return _results(router.step()), list(router._parked)
        (results, parked), _ = _both(scenario)
        assert [r[1:3] for r in results] == [("failed", "reroute_window")]
        assert parked == []

    def test_without_pending_spawn_fails_and_duplicates_refuse(self):
        def scenario(pkg):
            router = pkg.Router({0: pkg.engine()}, stale_s=0, shed_depth=0,
                                clock=FakeClock())
            router.submit(pkg.req(1, prompt=(1, 2, 3)))
            router.on_ranks_lost([0])
            out = [_results(router.step())]
            router = pkg.Router({0: pkg.engine()}, clock=FakeClock())
            with pytest.raises(ValueError) as e:
                router.add_replica(0, pkg.engine())
            out.append(str(e.value))
            return out
        (results, msg), _ = _both(scenario)
        assert [r[1:3] for r in results] == [("failed", "no_survivors")]
        assert "already live" in msg


class TestRouterBreaker:
    def test_rejected_dispatches_trip_and_probe_traffic_recovers(self):
        def scenario(pkg):
            clock = FakeClock()
            sick, ok = pkg.engine(accept=False), pkg.engine()
            sick.load = {"queue_depth": 0, "active_slots": 0,
                         "free_slots": 8, "free_blocks": 8}
            ok.load = {"queue_depth": 5, "active_slots": 8,
                       "free_slots": 0, "free_blocks": 8}
            br = pkg.CircuitBreaker(fails=2, probe_s=2.0, close_n=1,
                                    clock=clock)
            router = pkg.Router({0: sick, 1: ok}, breaker=br, stale_s=0,
                                shed_depth=0, clock=clock)
            out = [router.submit(pkg.req(1)), router.submit(pkg.req(2)),
                   br.state(0), router.submit(pkg.req(3)),
                   router.inflight.get("r3")]
            sick.accept = True
            clock.t = 3.0
            out += [router.submit(pkg.req(4)), router.inflight.get("r4")]
            sick.finish("r4")
            router.step()
            out.append(br.state(0))
            return out
        assert _both(scenario)[0] == [False, False, "open", True, 1, True,
                                      0, "closed"]

    def test_wedged_inflight_trips_the_breaker(self):
        def scenario(pkg):
            clock = FakeClock()
            br = pkg.CircuitBreaker(fails=3, timeout_s=5.0, probe_s=60.0,
                                    clock=clock)
            router = pkg.Router({0: pkg.engine(), 1: pkg.engine()},
                                breaker=br, stale_s=0, shed_depth=0,
                                clock=clock)
            router.submit(pkg.req(1))
            wedged_on = router.inflight["r1"]
            clock.t = 6.0
            router.step()
            return wedged_on, br.state(wedged_on)
        (wedged_on, state), snap = _both(scenario)
        assert state == "open"
        trips = [e for e in _events(snap, "route_breaker")
                 if e["reason"] == "wedged"]
        assert trips and trips[0]["replica"] == wedged_on


class TestElasticEndToEnd:
    def test_pressure_spawns_through_the_router(self):
        def scenario(pkg):
            clock = FakeClock()
            eng = pkg.engine()
            eng.load = {"queue_depth": 10, "active_slots": 8,
                        "free_slots": 0, "free_blocks": 8}

            def spawn(router):
                rid = max(router._handles) + 1
                return router.add_replica(rid, pkg.engine()).replica_id

            ctrl = pkg.ElasticityController(
                spawn=spawn, dwell_s=1.0, cooldown_s=100.0, window=4,
                up_depth=4.0, clock=clock)
            router = pkg.Router({0: eng}, elastic=ctrl, stale_s=0,
                                shed_depth=0, clock=clock)
            router.step()
            clock.t = 2.0
            router.step()
            return router.live_replicas(), _ctrl_record(ctrl)
        (live, rec), snap = _both(scenario)
        assert live == [0, 1] and rec["state"] == "grading"
        (ev,) = _events(snap, "route_elastic_scale_up")
        assert ev["replica"] == 1

    def test_idle_drains_through_the_router(self):
        def scenario(pkg):
            clock = FakeClock()
            ctrl = pkg.ElasticityController(
                spawn=None, dwell_s=1.0, cooldown_s=100.0, window=4,
                min_replicas=1, down_util=0.25, clock=clock)
            router = pkg.Router({0: pkg.engine(), 1: pkg.engine()},
                                elastic=ctrl, stale_s=0, shed_depth=0,
                                clock=clock)
            router.step()
            clock.t = 2.0
            router.step()
            return router.live_replicas(), sorted(
                (rid, h.state) for rid, h in router._handles.items())
        (live, states), _ = _both(scenario)
        assert len(live) == 1
        assert sorted(s for _, s in states) in (["draining", "live"],
                                                ["live", "retired"])


# ---------------------------------------------------------------------------
# the replica supervisor RPC door under chaos
# ---------------------------------------------------------------------------

def _addr_map(port):
    return {"local": [("127.0.0.1", port)]}


def _service(on_spawn="count", on_drain="count"):
    from horovod_tpu_torch.run.elastic import ReplicaSupervisorService
    calls = {"spawn": 0, "drain": []}

    def spawn():
        calls["spawn"] += 1
        return 40 + calls["spawn"]

    def drain(rid):
        calls["drain"].append(rid)
        return True
    if on_spawn == "count":
        on_spawn = spawn
    if on_drain == "count":
        on_drain = drain
    return ReplicaSupervisorService(KEY, on_spawn=on_spawn,
                                    on_drain=on_drain), calls


def _client(svc):
    from horovod_tpu_torch.run.elastic import ReplicaSupervisorClient
    c = ReplicaSupervisorClient(_addr_map(svc.port), KEY)
    c.backoff_base_s = 0.01
    return c


SPEC = "hvd elastic replica supervisor"


class TestReplicaSupervisorRPC:
    def test_service_name_matches_the_reference(self):
        from horovod_tpu.run.elastic import ReplicaSupervisorService as J
        from horovod_tpu_torch.run.elastic import ReplicaSupervisorService
        assert ReplicaSupervisorService.NAME == J.NAME == SPEC
        assert ReplicaSupervisorService.LEDGER_CAP == J.LEDGER_CAP

    def test_dropped_response_retries_without_double_spawn(self,
                                                           monkeypatch):
        monkeypatch.setenv("HVD_CHAOS_SPEC",
                           f"{SPEC}:ReplicaOpResponse:drop_response:1.0:1")
        monkeypatch.setenv("HVD_CHAOS_SEED", "3")
        svc, calls = _service()
        try:
            c = _client(svc)
            resp = c.spawn_replica("chg-1")
            assert sum(svc._chaos.stats().values()) == 1
            assert resp.ok and resp.replica_id == 41 and resp.duplicate
            assert calls["spawn"] == 1
            c.close()
        finally:
            svc.shutdown()

    def test_spawn_delivered_twice_executes_once(self, monkeypatch):
        """A SpawnReplicaRequest duplicated on the wire (chaos dup) runs
        the handler twice and the spawn hook once."""
        monkeypatch.setenv("HVD_CHAOS_SPEC",
                           f"{SPEC}:SpawnReplicaRequest:dup_request:1.0:1")
        svc, calls = _service()
        try:
            c = _client(svc)
            resp = c.spawn_replica("chg-dup")
            assert sum(svc._chaos.stats().values()) == 1
            assert resp.ok and resp.replica_id == 41
            assert calls["spawn"] == 1
            again = c.spawn_replica("chg-dup")
            assert again.duplicate and again.replica_id == 41
            assert calls["spawn"] == 1
            c.close()
        finally:
            svc.shutdown()

    def test_duplicated_drain_is_idempotent(self, monkeypatch):
        monkeypatch.setenv("HVD_CHAOS_SPEC",
                           f"{SPEC}:DrainReplicaRequest:dup_request:1.0:1")
        svc, calls = _service()
        try:
            c = _client(svc)
            resp = c.drain_replica("chg-2", 1)
            assert sum(svc._chaos.stats().values()) == 1
            assert resp.ok and resp.replica_id == 1
            assert calls["drain"] == [1]
            c.close()
        finally:
            svc.shutdown()

    def test_delayed_drain_completes_within_bound(self, monkeypatch):
        monkeypatch.setenv("HVD_CHAOS_SPEC",
                           f"{SPEC}:DrainReplicaRequest:delay_request:1.0:1")
        monkeypatch.setenv("HVD_CHAOS_DELAY_MS", "200")
        svc, calls = _service()
        try:
            c = _client(svc)
            t0 = time.monotonic()
            resp = c.drain_replica("chg-3", 2)
            elapsed = time.monotonic() - t0
            assert resp.ok and calls["drain"] == [2]
            assert 0.15 <= elapsed < 10.0
            c.close()
        finally:
            svc.shutdown()

    def test_distinct_change_ids_execute_separately(self):
        svc, calls = _service()
        try:
            c = _client(svc)
            a = c.spawn_replica("chg-a")
            b = c.spawn_replica("chg-b")
            again = c.spawn_replica("chg-a")
            assert (a.replica_id, b.replica_id) == (41, 42)
            assert again.replica_id == 41 and again.duplicate
            assert calls["spawn"] == 2
            c.close()
        finally:
            svc.shutdown()

    def test_hook_exception_fails_loud_by_name(self):
        def bad_spawn():
            raise RuntimeError("no capacity on any host")
        svc, _ = _service(on_spawn=bad_spawn)
        try:
            c = _client(svc)
            resp = c.spawn_replica("chg-x")
            assert not resp.ok and "no capacity" in resp.detail
            assert c.spawn_replica("chg-x").duplicate
            c.close()
        finally:
            svc.shutdown()

    def test_unconfigured_hooks_refuse(self):
        svc, _ = _service(on_spawn=None, on_drain=None)
        try:
            c = _client(svc)
            assert not c.spawn_replica("c1").ok
            assert not c.drain_replica("c2", 0).ok
            c.close()
        finally:
            svc.shutdown()

    def test_ledger_is_bounded(self, monkeypatch):
        from horovod_tpu_torch.run.elastic import ReplicaSupervisorService
        monkeypatch.setattr(ReplicaSupervisorService, "LEDGER_CAP", 2)
        svc, calls = _service()
        try:
            c = _client(svc)
            for cid in ("a", "b", "c"):
                c.spawn_replica(cid)
            assert list(svc._ledger) == ["b", "c"]
            assert not c.spawn_replica("a").duplicate  # aged out
            assert calls["spawn"] == 4
            c.close()
        finally:
            svc.shutdown()
