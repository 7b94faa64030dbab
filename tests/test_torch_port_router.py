"""horovod_tpu_torch's router plane against the JAX package's.

The cases of tests/test_router.py (dispatch scoring, cache-affinity
stickiness, the exactly-once reroute ledger on replica loss, the
SLO-gated canary state machine and its integration with the router), each
one script on a ``FakeEngine`` and a ``FakeClock`` that drives both
packages' ``Router`` and ``CanaryController``. The two must make equal
decisions: the replica per request, affinity outcomes, reroutes, canary
begin/promote/rollback with their evidence, the events and the metric
values; each case then holds the port's record to the JAX test's
expectations.
"""

import pytest


class Pkg:
    """One package's router-plane surface, by name."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            from horovod_tpu import router
            from horovod_tpu.router import canary, policy
            from horovod_tpu.serving import queue
            from horovod_tpu.utils import metrics
        else:
            from horovod_tpu_torch import router
            from horovod_tpu_torch.router import canary, policy
            from horovod_tpu_torch.serving import queue
            from horovod_tpu_torch.utils import metrics
        self.router, self.canary, self.policy = router, canary, policy
        self.queue, self.metrics = queue, metrics
        self.Router = router.Router
        self.CanaryController = router.CanaryController
        self.Request = queue.Request
        self.RequestResult = queue.RequestResult

    def engine(self, **kw):
        return FakeEngine(self, **kw)

    def req(self, i, prompt=None, max_new_tokens=8):
        return self.Request(request_id=f"r{i}",
                            prompt=prompt if prompt is not None
                            else (100 + i, 200 + i, 300 + i),
                            max_new_tokens=max_new_tokens)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class FakeEngine:
    """ServeEngine stand-in: holds admitted requests until the script
    says finish(), and lets it pin the load snapshot exactly."""

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

    def finish(self, request_id, tokens=(5, 6, 7)):
        req = self.held.pop(request_id)
        self._done.append(self.pkg.RequestResult(
            req.request_id, tuple(tokens), "completed", ttft_s=0.01,
            generation=self.generation))

    def step(self):
        out, self._done = self._done, []
        return out


def _value(snap, name, **labels):
    fam = snap["metrics"].get(name)
    if fam is None:
        return None
    for v in fam["values"]:
        if all(v["labels"].get(k) == lv for k, lv in labels.items()):
            return v.get("value", v.get("count"))
    return None


def _events(snap, kind):
    """The ``kind`` events without their clock stamps."""
    return [{k: v for k, v in e.items() if k not in ("ts_us", "epoch_us")}
            for e in snap["events"] if e["event"] == kind]


def _families(snap, prefix="hvd_route_"):
    """Every ``prefix`` metric family's values, by labels."""
    out = {}
    for name, fam in sorted(snap["metrics"].items()):
        if name.startswith(prefix):
            out[name] = sorted(
                (sorted(v["labels"].items()),
                 v.get("value", v.get("count"))) for v in fam["values"])
    return out


def _results(results):
    return [(r.request_id, r.outcome, r.reason, r.replica, r.rerouted,
             r.generation) for r in results]


def _both(scenario):
    """``scenario(pkg)`` for each package with a fresh registry; asserts
    equal records (the scenario's own and every route event and metric)
    and returns the port's."""
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
            out[name] = (rec, events, _families(snap), snap)
        finally:
            pkg.metrics.reset()
    assert out["torch"][:3] == out["jax"][:3]
    return out["torch"][0], out["torch"][3]


# ---------------------------------------------------------------------------
# policy scoring math
# ---------------------------------------------------------------------------

LOADS = [None, {}, {"queue_depth": 2, "active_slots": 3, "work_tokens": 8,
                    "free_blocks": 4},
         {"queue_depth": 0, "free_blocks": 0},
         {"queue_depth": 10, "free_blocks": 5},
         {"queue_depth": 1, "work_tokens": 40},
         {"queue_depth": 1, "work_tokens": 8},
         {"queue_depth": None, "active_slots": None, "free_blocks": None}]


class TestPolicyScore:
    def test_scores_and_constants_equal(self):
        def scenario(pkg):
            p = pkg.policy
            return ([p.score(x) for x in LOADS],
                    (p.QUEUE_WEIGHT, p.SLOT_WEIGHT, p.WORK_WEIGHT,
                     p.KV_EXHAUSTED_PENALTY, p.AFFINITY_SLACK),
                    sorted(p.POLICIES))
        (scores, consts, names), _ = _both(scenario)
        assert scores[:2] == [0.0, 0.0]
        assert scores[2] == pytest.approx(2 * 4.0 + 3 * 1.0 + 8 * 0.125)
        assert scores[3] == consts[3] and scores[4] < scores[3]
        assert scores[5] > scores[6]
        assert names == ["least_loaded", "round_robin"]

    def test_round_robin_cycles_id_order(self):
        (picks, _) = _both(lambda pkg: [
            pkg.policy.RoundRobin().choose([2, 0, 1], {})] + [
            p.choose([2, 0, 1], {}) for p in [pkg.policy.RoundRobin()]
            for _ in range(4)])
        assert picks[1:] == [0, 1, 2, 0]

    def test_least_loaded_picks_min_with_id_tiebreak(self):
        def scenario(pkg):
            p = pkg.policy.LeastLoaded()
            loads = {0: {"queue_depth": 2}, 1: {"queue_depth": 1},
                     2: {"queue_depth": 1}}
            return [p.choose([0, 1, 2], loads), p.choose([0, 2], loads),
                    p.choose([0, 3], {0: {"queue_depth": 1}})]
        assert _both(scenario)[0] == [1, 2, 3]

    def test_prefix_key(self):
        rec, _ = _both(lambda pkg: [
            pkg.policy.prefix_key((1, 2, 3, 4), 2),
            pkg.policy.prefix_key((1, 2), 8),
            pkg.policy.prefix_key((1, 2), 0),
            pkg.policy.prefix_key((), 8)])
        assert rec == [(1, 2), (1, 2), None, None]

    def test_resolve_env_and_unknown(self, monkeypatch):
        def scenario(pkg):
            out = [type(pkg.policy.resolve("round_robin")).__name__]
            monkeypatch.setenv("HVD_ROUTE_POLICY", "round_robin")
            out.append(type(pkg.policy.resolve()).__name__)
            monkeypatch.delenv("HVD_ROUTE_POLICY")
            out.append(type(pkg.policy.resolve()).__name__)
            with pytest.raises(ValueError, match="HVD_ROUTE_POLICY") as e:
                pkg.policy.resolve("fastest_ever")
            out.append(str(e.value))
            return out
        rec, _ = _both(scenario)
        assert rec[:3] == ["RoundRobin", "RoundRobin", "LeastLoaded"]


# ---------------------------------------------------------------------------
# dispatch + affinity stickiness
# ---------------------------------------------------------------------------

class TestDispatch:
    def test_least_loaded_alternates_idle_replicas(self):
        def scenario(pkg):
            engines = {0: pkg.engine(), 1: pkg.engine()}
            router = pkg.Router(engines, policy="least_loaded",
                                affinity_prefix=0)
            admitted = [router.submit(pkg.req(i)) for i in range(4)]
            return (admitted, sorted(engines[0].held),
                    sorted(engines[1].held), router.inflight)
        (admitted, e0, e1, inflight), snap = _both(scenario)
        assert admitted == [True] * 4
        assert (e0, e1) == (["r0", "r2"], ["r1", "r3"])
        assert inflight == {"r0": 0, "r1": 1, "r2": 0, "r3": 1}
        assert _value(snap, "hvd_route_requests_total", replica="0") == 2

    def test_step_stamps_serving_replica(self):
        def scenario(pkg):
            engines = {0: pkg.engine(), 1: pkg.engine()}
            router = pkg.Router(engines, policy="least_loaded",
                                affinity_prefix=0)
            router.submit(pkg.req(0))
            router.submit(pkg.req(1))
            engines[1].finish("r1")
            first = _results(router.step())
            mid = (router.inflight, router.pending())
            engines[0].finish("r0")
            second = _results(router.step())
            return first, mid, second, router.pending()
        first, mid, second, pending = _both(scenario)[0]
        assert first == [("r1", "completed", "", 1, False, 1)]
        assert mid == ({"r0": 0}, True)
        assert second[0][:4] == ("r0", "completed", "", 0)
        assert not pending

    def test_affinity_sticks_within_slack_then_overflows(self):
        def scenario(pkg):
            engines = {0: pkg.engine(), 1: pkg.engine()}
            engines[0].load = {"queue_depth": 0}
            engines[1].load = {"queue_depth": 0}
            router = pkg.Router(engines, policy="least_loaded",
                                affinity_prefix=4)
            prefix = (1, 2, 3, 4)
            where = []
            for rid, depth, tail in (("a0", 0, 9), ("a1", 2, 8),
                                     ("a2", 3, 7), ("a3", 3, 6)):
                engines[0].load = {"queue_depth": depth}
                router.submit(pkg.Request(rid, prefix + (tail,)))
                where.append(router.inflight[rid])
            return where
        where, snap = _both(scenario)
        assert where == [0, 0, 1, 1]
        assert [_value(snap, "hvd_route_affinity_total", outcome=o)
                for o in ("miss", "hit", "overflow")] == [1, 2, 1]

    def test_distinct_prefixes_do_not_share_stickiness(self):
        def scenario(pkg):
            engines = {0: pkg.engine(), 1: pkg.engine()}
            router = pkg.Router(engines, policy="least_loaded",
                                affinity_prefix=4)
            router.submit(pkg.Request("p0", (1, 1, 1, 1, 5)))
            router.submit(pkg.Request("p1", (2, 2, 2, 2, 5)))
            return router.inflight
        assert _both(scenario)[0] == {"p0": 0, "p1": 1}

    def test_rejecting_replica_surfaces_backpressure(self):
        def scenario(pkg):
            router = pkg.Router({0: pkg.engine(accept=False)},
                                affinity_prefix=0)
            return router.submit(pkg.req(0)), router.inflight
        assert _both(scenario)[0] == (False, {})

    @pytest.mark.parametrize("policy", ["least_loaded", "round_robin"])
    def test_seeded_traffic_makes_equal_decisions(self, policy):
        """A longer script: 40 requests with seeded prompts (shared
        prefixes among them), lengths and completions over 3 replicas; the
        replica of every request, and every route event and metric, equal
        in both packages."""
        import random

        def scenario(pkg):
            rnd = random.Random(11)
            clock = FakeClock()
            engines = {r: pkg.engine() for r in range(3)}
            router = pkg.Router(engines, policy=policy, affinity_prefix=2,
                                clock=clock)
            where, done = {}, []
            for i in range(40):
                clock.t += 0.25
                prompt = (rnd.randrange(3), rnd.randrange(3),
                          rnd.randrange(50))
                req = pkg.Request(f"q{i}", prompt,
                                  max_new_tokens=rnd.choice((8, 40)))
                if router.submit(req):
                    where[req.request_id] = router.inflight[req.request_id]
                for eng in engines.values():
                    for rid in sorted(eng.held):
                        if rnd.random() < 0.3:
                            eng.finish(rid)
                done.extend(_results(router.step()))
            return where, done
        (where, done), snap = _both(scenario)
        assert len(where) == 40 and len(set(where.values())) == 3


# ---------------------------------------------------------------------------
# replica loss -> exactly-once reroute
# ---------------------------------------------------------------------------

def _lossy(pkg, clock=None):
    engines = {0: pkg.engine(), 1: pkg.engine()}
    router = pkg.Router(engines, policy="least_loaded", affinity_prefix=0,
                        reroute_window_s=30.0, clock=clock or FakeClock())
    for i in range(4):
        router.submit(pkg.req(i))
    return engines, router


class TestReroute:
    def test_loss_requeues_to_survivor_exactly_once(self):
        def scenario(pkg):
            engines, router = _lossy(pkg)
            router.on_ranks_lost([1])
            first = (router.live_replicas(), sorted(engines[0].held),
                     router.inflight)
            router.on_ranks_lost([1])
            return first, sorted(engines[0].held)
        (first, again), snap = _both(scenario)
        assert first[0] == [0]
        assert first[1] == again == ["r0", "r1", "r2", "r3"]
        assert set(first[2].values()) == {0}
        assert _value(snap, "hvd_route_rerouted_total") == 2
        assert _value(snap, "hvd_route_replicas_live") == 1
        assert [e["inflight"] for e in _events(snap, "route_replica_lost")
                ] == [["r1", "r3"], []]
        assert {(e["request_id"], e["from_replica"], e["to_replica"])
                for e in _events(snap, "route_reroute")} == {
            ("r1", 1, 0), ("r3", 1, 0)}

    def test_rerouted_results_are_stamped(self):
        def scenario(pkg):
            engines, router = _lossy(pkg)
            router.on_ranks_lost([1])
            for rid in list(engines[0].held):
                engines[0].finish(rid)
            return _results(router.step()), router.pending()
        (results, pending), _ = _both(scenario)
        assert len(results) == 4 and not pending
        assert {r[0] for r in results if r[4]} == {"r1", "r3"}
        assert {r[3] for r in results} == {0}

    def test_stale_request_fails_loud_instead_of_resurrecting(self):
        def scenario(pkg):
            clock = FakeClock()
            engines, router = _lossy(pkg, clock)
            clock.t = 31.0
            router.on_ranks_lost([1])
            return sorted(engines[0].held), _results(router.step())
        (held, results), _ = _both(scenario)
        assert held == ["r0", "r2"]
        assert sorted(r[0] for r in results if r[1] == "failed") == [
            "r1", "r3"]
        assert all(r[2:4] == ("reroute_window", 1) for r in results)

    def test_no_survivors_fails_the_orphans(self):
        def scenario(pkg):
            router = pkg.Router({0: pkg.engine()}, affinity_prefix=0,
                                clock=FakeClock())
            router.submit(pkg.req(0))
            router.on_ranks_lost([0])
            return _results(router.step()), router.inflight
        (results, inflight), _ = _both(scenario)
        assert [r[1:3] for r in results] == [("failed", "no_survivors")]
        assert inflight == {}

    def test_survivor_rejection_fails_not_drops(self):
        def scenario(pkg):
            engines = {0: pkg.engine(), 1: pkg.engine()}
            router = pkg.Router(engines, policy="least_loaded",
                                affinity_prefix=0, clock=FakeClock())
            router.submit(pkg.req(0))
            engines[1].accept = False
            router.on_ranks_lost([0])
            return _results(router.step())
        results, _ = _both(scenario)
        assert [r[1:3] for r in results] == [("failed", "reroute_rejected")]


# ---------------------------------------------------------------------------
# canary rollout on synthetic histograms
# ---------------------------------------------------------------------------

def _canary(pkg, **kw):
    kw.setdefault("pct", 50.0)
    kw.setdefault("window", 4)
    kw.setdefault("min_delta_s", 0.025)
    return pkg.CanaryController(clock=FakeClock(), **kw)


def _armed_loads(gen=2, replica=1):
    return {0: {"generation": 1, "armed_generation": None},
            replica: {"generation": 1, "armed_generation": gen}}


def _res(pkg, i, gen, ttft=0.008, tokens=8, outcome="completed"):
    return pkg.RequestResult(f"c{i}", tuple(range(tokens)), outcome,
                             ttft_s=ttft, generation=gen)


def _fill(pkg, ctrl, canary_ttft=0.008, baseline_ttft=0.008,
          canary_outcomes=("completed",) * 4):
    for i in range(ctrl.window):
        ctrl.observe(_res(pkg, f"b{i}", 1, ttft=baseline_ttft), 0)
    for i, outcome in enumerate(canary_outcomes):
        ctrl.observe(_res(pkg, f"k{i}", 2, ttft=canary_ttft,
                          outcome=outcome), 1)


def _canary_state(ctrl):
    return {"state": ctrl.state, "generation": ctrl.canary_generation,
            "replicas": sorted(ctrl.canary_replicas),
            "quarantined": sorted(ctrl.quarantined),
            "decisions": ctrl.decisions}


def _ids(pkg, to_canary, pct=50.0):
    h = pkg.canary._hash_pct
    return [f"q{i}" for i in range(200) if (h(f"q{i}") < pct) == to_canary]


class TestCanary:
    def test_hash_buckets_equal(self):
        rec, _ = _both(lambda pkg: [pkg.canary._hash_pct(f"req-{i}")
                                    for i in range(500)])
        assert set(rec) <= set(range(100))

    def test_tick_begins_on_armed_generation(self):
        def scenario(pkg):
            ctrl = _canary(pkg)
            ctrl.tick({0: {"generation": 1, "armed_generation": None}})
            idle = ctrl.state
            ctrl.tick(_armed_loads(gen=2, replica=1))
            return idle, _canary_state(ctrl)
        (idle, st), snap = _both(scenario)
        assert idle == "idle"
        assert (st["state"], st["generation"], st["replicas"]) == (
            "canary", 2, [1])
        (begin,) = _events(snap, "route_canary_begin")
        assert begin["generation"] == 2 and begin["replicas"] == [1]

    def test_cohort_bounded_when_everyone_arms(self):
        def scenario(pkg):
            ctrl = _canary(pkg, max_canary_replicas=1)
            ctrl.tick({r: {"generation": 1, "armed_generation": 2}
                       for r in range(4)})
            return (sorted(ctrl.canary_replicas), ctrl.allows_swap(3, 2),
                    ctrl.allows_swap(0, 2))
        assert _both(scenario)[0] == ([0], False, True)

    def test_filter_splits_traffic_by_stable_hash(self):
        def scenario(pkg):
            ctrl = _canary(pkg)
            ctrl.tick(_armed_loads())
            loads = {0: {"generation": 1}, 1: {"generation": 2}}
            c, b = _ids(pkg, True)[0], _ids(pkg, False)[0]
            return [ctrl.filter(c, [0, 1], loads),
                    ctrl.filter(b, [0, 1], loads),
                    ctrl.filter(c, [0, 1], loads),
                    ctrl.filter(c, [0], {0: {"generation": 1}})]
        assert _both(scenario)[0] == [[1], [0], [1], [0]]

    @pytest.mark.parametrize("case", [
        "promote", "ttft_breach", "min_delta", "goodput_drop"])
    def test_verdicts(self, case):
        kwargs = {"promote": {},
                  "ttft_breach": {"canary_ttft": 0.4},
                  "min_delta": {"canary_ttft": 0.004,
                                "baseline_ttft": 0.002},
                  "goodput_drop": {"canary_outcomes": (
                      "completed", "completed", "failed", "failed")}}[case]

        def scenario(pkg):
            ctrl = _canary(pkg)
            ctrl.tick(_armed_loads())
            held = ctrl.allows_swap(0, 2)
            _fill(pkg, ctrl, **kwargs)
            loads = {0: {"generation": 2}, 1: {"generation": 1}}
            return (held, _canary_state(ctrl), ctrl.allows_swap(0, 2),
                    ctrl.filter("any", [0, 1], loads))
        (held, st, opened, routed), snap = _both(scenario)
        assert not held
        verdict, evidence = st["decisions"][-1]
        if case in ("promote", "min_delta"):
            assert st["state"] == "promoted" and verdict == "promote"
            assert opened
            assert _value(snap, "hvd_route_canary_fraction") == 100
        else:
            assert st["state"] == "rolled_back" and verdict == "rollback"
            assert st["quarantined"] == [2] and not opened
            assert routed == [1]
            assert _value(snap, "hvd_route_canary_fraction") == 0
            assert evidence["breaches"] == (
                ["ttft_p99"] if case == "ttft_breach" else
                ["goodput_ratio"])

    def test_cohort_is_the_generation_not_the_replica(self):
        def scenario(pkg):
            ctrl = _canary(pkg)
            ctrl.tick(_armed_loads())
            for i in range(ctrl.window):
                ctrl.observe(_res(pkg, f"o{i}", 1), 1)
            return (ctrl._stats["baseline"].n, ctrl._stats["canary"].n,
                    ctrl.state)
        assert _both(scenario)[0] == (4, 0, "canary")

    def test_quarantined_generation_never_recanaries(self):
        def scenario(pkg):
            ctrl = _canary(pkg)
            ctrl.tick(_armed_loads(gen=2))
            _fill(pkg, ctrl, canary_ttft=0.4)
            out = [ctrl.state]
            ctrl.tick(_armed_loads(gen=2))
            out.append(ctrl.state)
            ctrl.tick(_armed_loads(gen=3))
            out += [ctrl.state, ctrl.canary_generation]
            return out
        assert _both(scenario)[0] == ["rolled_back", "rolled_back",
                                      "canary", 3]

    def test_promoted_generation_not_reevaluated(self):
        def scenario(pkg):
            ctrl = _canary(pkg)
            ctrl.tick(_armed_loads(gen=2))
            _fill(pkg, ctrl)
            out = [ctrl.state]
            ctrl.tick(_armed_loads(gen=2))
            out.append(ctrl.state)
            ctrl.tick(_armed_loads(gen=3))
            out += [ctrl.state, ctrl.canary_generation]
            return out
        assert _both(scenario)[0] == ["promoted", "promoted", "canary", 3]

    def test_unclaimed_generation_is_held_until_the_tick(self):
        """A generation armed after the router's tick (the loader is a
        thread) is held by the port's gate until the next tick claims it;
        the JAX package lets the first replica to poll swap through the
        idle gate, which then serves the baseline cohort on the new
        weights and the canary's baseline window never fills. Once the
        tick has claimed it, both packages gate alike."""
        def scenario(pkg):
            ctrl = _canary(pkg, max_canary_replicas=1)
            before = [ctrl.allows_swap(r, 2) for r in (0, 1)]
            ctrl.tick(_armed_loads(gen=2, replica=1))
            claimed = [ctrl.allows_swap(r, 2) for r in (0, 1)]
            newer = ctrl.allows_swap(1, 3)
            return before, claimed, newer
        got = {}
        for name in ("jax", "torch"):
            pkg = Pkg(name)
            pkg.metrics.reset(enabled=True)
            try:
                got[name] = scenario(pkg)
            finally:
                pkg.metrics.reset()
        assert got["jax"] == ([True, True], [False, True], True)
        assert got["torch"] == ([False, False], [False, True], False)


class TestRouterWithCanary:
    def test_dispatch_respects_cohort_and_results_feed_verdict(self):
        def scenario(pkg):
            engines = {0: pkg.engine(generation=1),
                       1: pkg.engine(generation=1)}
            ctrl = _canary(pkg)
            router = pkg.Router(engines, policy="least_loaded",
                                affinity_prefix=0, canary=ctrl)
            engines[1].load = {"generation": 1, "armed_generation": 2}
            router.step()
            began = ctrl.state
            engines[1].load = None
            engines[1].generation = 2
            canary_ids = _ids(pkg, True)[:4]
            base_ids = _ids(pkg, False)[:4]
            admitted = [router.submit(pkg.Request(rid, (1, 2, 3)))
                        for rid in canary_ids + base_ids]
            held = (sorted(engines[1].held), sorted(engines[0].held))
            for rid in canary_ids:
                engines[1].finish(rid)
            for rid in base_ids:
                engines[0].finish(rid)
            results = _results(router.step())
            return (began, admitted, held, canary_ids, base_ids, results,
                    _canary_state(ctrl))
        (began, admitted, held, cids, bids, results, st), snap = \
            _both(scenario)
        assert began == "canary" and all(admitted)
        assert held == (sorted(cids), sorted(bids))
        assert st["state"] == "promoted"
        assert _events(snap, "route_promote")
