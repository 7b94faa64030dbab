"""The port's telemetry plane (``horovod_tpu_torch/utils/metrics.py``)
against the JAX package's (``horovod_tpu/utils/metrics.py``), mirroring
``tests/test_metrics.py:29-422`` and its two-rank scrape (``:565``).

Parity is equality wherever the output is determined by the inputs: one
seeded sequence of counter, gauge, histogram and event calls through both
registries gives equal snapshots once the clock stamps (``ts_us``,
``epoch_us``, ``epoch_us_at_ts0``) are dropped, the same Prometheus
text, each package's parser reads the other's text, and
``merge_snapshots`` of per-rank registries is equal. The coordinator,
fusion and chaos instruments are driven with the same inputs in both
packages and hold equal values. The two-rank scrape over gloo holds
invariants (both ranks in rank 0's aggregate, cycle counts above a floor),
since cycle counts depend on timing.
"""

import json
import os
import time
import urllib.request

import numpy as np
import pytest
import torch

from horovod_tpu.utils import metrics as jm
from horovod_tpu_torch.run.launch import run
from horovod_tpu_torch.utils import metrics as tm

RUN_TIMEOUT_S = 120.0
PKGS = {"port": tm, "jax": jm}


@pytest.fixture
def regs():
    """Fresh enabled process registries of both packages."""
    t, j = tm.reset(enabled=True), jm.reset(enabled=True)
    yield t, j
    tm.reset()
    jm.reset()


def _clockless(snap):
    """A snapshot without its clock stamps (each package has its own)."""
    out = {k: v for k, v in snap.items()
           if k not in ("ts_us", "epoch_us_at_ts0")}
    out["events"] = [{k: v for k, v in e.items()
                      if k not in ("ts_us", "epoch_us")}
                     for e in snap.get("events", ())]
    return out


def _drive(reg, seed=0, rank=0):
    """One seeded sequence of instrument and event calls."""
    rng = np.random.default_rng(seed + 17 * rank)
    reg.counter("hvd_negotiation_cycles_total", "cycles").inc(
        int(rng.integers(1, 50)))
    ops = reg.counter("hvd_collective_bytes_total", "bytes by op",
                      labels=("op",))
    for op in ("allreduce", "allgather", "allreduce"):
        ops.labels(op=op).inc(int(rng.integers(1, 1 << 20)))
    reg.gauge("hvd_stalled_tensors").set(int(rng.integers(0, 4)))
    g = reg.gauge("t_gauge", labels=("k",))
    g.labels(k='a,"b"').set(float(rng.random()))
    g.labels(k="z").inc(3)
    h = reg.histogram("hvd_flush_seconds", "flush",
                      buckets=jm.LATENCY_BUCKETS)
    for v in rng.exponential(0.01, size=20):
        h.observe(float(v))
    c = reg.histogram("hvd_flush_tensors", buckets=jm.COUNT_BUCKETS)
    for v in rng.integers(0, 300, size=9):
        c.observe(int(v))
    for i in range(3):
        reg.event("stall", tensor=f"g{i}", missing_ranks=[int(i % 2)],
                  rank=rank)
    return reg


class TestSnapshotParity:
    def test_bucket_tuples_equal(self):
        for name in ("LATENCY_BUCKETS", "RATIO_BUCKETS", "COUNT_BUCKETS",
                     "SERVE_PHASE_BUCKETS"):
            assert getattr(tm, name) == getattr(jm, name), name

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_snapshot_and_prometheus_equal(self, seed):
        t = _drive(tm.MetricsRegistry(rank=0), seed)
        j = _drive(jm.MetricsRegistry(rank=0), seed)
        ts, js = t.snapshot(), j.snapshot()
        assert _clockless(ts) == _clockless(js)
        assert tm.render_prometheus(ts) == jm.render_prometheus(js)
        assert t.to_prometheus({"job": "x"}) == \
            j.to_prometheus({"job": "x"})

    def test_each_parser_reads_the_others_text(self):
        t = _drive(tm.MetricsRegistry(rank=0), 3)
        j = _drive(jm.MetricsRegistry(rank=0), 3)
        t_text, j_text = t.to_prometheus(), j.to_prometheus()
        assert tm.parse_prometheus(j_text) == jm.parse_prometheus(j_text)
        assert jm.parse_prometheus(t_text) == tm.parse_prometheus(t_text)
        assert tm.parse_prometheus(j_text) == jm.parse_prometheus(t_text)

    def test_merge_of_per_rank_registries_equal(self):
        merged = {}
        for name, mod in PKGS.items():
            snaps = [_drive(mod.MetricsRegistry(rank=r), 5, rank=r)
                     .snapshot() for r in range(3)]
            merged[name] = mod.merge_snapshots(snaps)
        # events order by epoch, which differs per package: compare as
        # sorted lists
        t, j = (_clockless(merged[k]) for k in ("port", "jax"))
        key = json.dumps
        t["events"] = sorted(t["events"], key=key)
        j["events"] = sorted(j["events"], key=key)
        assert t == j
        assert merged["port"]["ranks"] == [0, 1, 2]

    def test_histogram_quantile_equal(self):
        rng = np.random.default_rng(9)
        bounds = jm.LATENCY_BUCKETS
        for _ in range(5):
            counts = [int(c) for c in rng.integers(0, 20,
                                                   len(bounds) + 1)]
            for q in (0.5, 0.9, 0.99):
                assert tm.histogram_quantile(bounds, counts, q) == \
                    jm.histogram_quantile(bounds, counts, q)


class TestInstruments:
    """``tests/test_metrics.py`` TestInstruments on the port."""

    def test_counter_gauge_histogram(self, regs):
        reg = regs[0]
        c = reg.counter("t_c", "help text")
        c.inc()
        c.inc(2.5)
        assert c.value == 3.5
        g = reg.gauge("t_g")
        g.set(7)
        g.inc(-2)
        assert g.value == 5.0
        h = reg.histogram("t_h", buckets=(1.0, 2.0, 4.0)).labels()
        for v in (0.5, 1.5, 1.5, 3.0, 99.0):
            h.observe(v)
        assert h.counts == [1, 2, 1, 1]
        assert h.count == 5
        assert h.sum == pytest.approx(105.5)

    def test_observe_many_equals_observe(self):
        """The port's bulk ``observe_many`` (the tracer's group close)
        lands every value in the bucket ``observe`` puts it in."""
        rng = np.random.default_rng(4)
        vals = list(rng.exponential(0.02, 500)) + \
            [0.0005, 0.001, 0.0025, 10.0, 99.0, 0.0]
        one, bulk = tm.Histogram(tm.LATENCY_BUCKETS), \
            tm.Histogram(tm.LATENCY_BUCKETS)
        ref = jm.Histogram(jm.LATENCY_BUCKETS)
        for v in vals:
            one.observe(v)
            ref.observe(v)
        bulk.observe_many(vals)
        assert one.counts == bulk.counts == ref.counts
        assert one.count == bulk.count == len(vals)
        assert bulk.sum == pytest.approx(one.sum, rel=1e-12)

    def test_registration_errors(self, regs):
        reg = regs[0]
        with pytest.raises(ValueError, match="not sorted"):
            tm.Histogram((2.0, 1.0))
        assert reg.counter("t_same") is reg.counter("t_same")
        reg.counter("t_kind")
        with pytest.raises(ValueError, match="re-registered"):
            reg.gauge("t_kind")
        reg.histogram("t_b", buckets=(1.0, 2.0))
        with pytest.raises(ValueError, match="different buckets"):
            reg.histogram("t_b", buckets=(1.0, 3.0))

    def test_event_ring_and_shared_clock(self, regs):
        reg = regs[0]
        ev = reg.event("stall", tensor="grad0", missing_ranks=[1])
        clock = tm.shared_clock()
        assert ev["epoch_us"] == clock.epoch_us_at_ts0 + ev["ts_us"]
        assert reg.events()[-1] is ev
        # the ns base the native timeline takes is the float base's
        assert clock.base == pytest.approx(clock.base_ns / 1e9)

    def test_event_ring_drops_oldest(self):
        for mod in PKGS.values():
            reg = mod.MetricsRegistry()
            for i in range(reg.EVENT_RING + 5):
                reg.event("e", i=i)
            snap = reg.snapshot()
            assert snap["events_dropped"] == 5
            assert snap["events"][0]["i"] == 5

    def test_null_registry_and_kill_switch(self, monkeypatch):
        r = tm.reset(enabled=False)
        try:
            assert not r.enabled
            r.counter("x").inc()
            r.gauge("y").labels(op="z").set(5)
            r.histogram("h").observe(1.0)
            assert r.event("stall") is None
            assert r.snapshot()["metrics"] == {}
            assert r.to_prometheus() == ""
            monkeypatch.setenv("HVD_METRICS", "0")
            assert isinstance(tm.reset(), tm.NullRegistry)
        finally:
            monkeypatch.delenv("HVD_METRICS", raising=False)
            tm.reset()

    def test_tally_reads_counters_since_reset(self, regs):
        reg = regs[0]
        tally = tm.Tally(("t_a", "t_b"), gauges=("t_g",))
        reg.counter("t_a").inc(2)
        tally.reset()
        reg.counter("t_a").inc(3)
        reg.counter("t_b", labels=("k",)).labels(k="x").inc(1)
        reg.gauge("t_g").set(4)
        assert tally.read() == {("t_a",): 3.0, ("t_b", "x"): 1.0,
                                ("t_g",): 4.0}
        # a replaced registry counts from zero
        tm.reset(enabled=True).counter("t_a").inc(1)
        assert tally.read() == {("t_a",): 1.0}


class TestHTTPServer:
    def _get(self, port, path):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
            return resp.read().decode()

    def test_scrape_round_trip_with_remote_aggregate(self):
        local = tm.MetricsRegistry(rank=0)
        local.counter("hvd_negotiation_cycles_total").inc(5)
        remote = tm.MetricsRegistry(rank=1)
        remote.counter("hvd_negotiation_cycles_total").inc(7)
        srv = tm.MetricsServer(
            0, local.snapshot,
            remote_snapshots_fn=lambda: {1: remote.snapshot()},
            host="127.0.0.1")
        try:
            parsed = jm.parse_prometheus(self._get(srv.port, "/metrics"))
            (_, v), = parsed["hvd_negotiation_cycles_total"]["samples"]
            assert v == 12
            data = json.loads(self._get(srv.port, "/metrics.json"))
            assert set(data["ranks"]) == {"0", "1"}
            assert data["aggregate"]["ranks"] == [0, 1]
        finally:
            srv.close()

    def test_live_local_registry_wins_over_stale_self_snapshot(self):
        local = tm.MetricsRegistry(rank=0)
        c = local.counter("hvd_coordinator_cycles_total")
        c.inc(3)
        stale = local.snapshot()
        c.inc(97)
        srv = tm.MetricsServer(0, local.snapshot,
                               remote_snapshots_fn=lambda: {0: stale},
                               host="127.0.0.1")
        try:
            parsed = tm.parse_prometheus(self._get(srv.port, "/metrics"))
            (_, v), = parsed["hvd_coordinator_cycles_total"]["samples"]
            assert v == 100
        finally:
            srv.close()


def _services(nproc=2, packages=("port", "jax"), **cfg_kw):
    """The coordinator service of each package on the same config."""
    from horovod_tpu.common.config import HorovodConfig as JC
    from horovod_tpu.ops import negotiation as jneg
    from horovod_tpu_torch.common.config import HorovodConfig as TC
    from horovod_tpu_torch.ops import negotiation as tneg
    cfg_kw.setdefault("stall_warning_time_seconds", 0)
    out = {}
    for name, cfg, neg in (("port", TC, tneg), ("jax", JC, jneg)):
        if name in packages:
            out[name] = (neg.CoordinatorService(
                nproc, b"k" * 32, ports=[0], config=cfg(**cfg_kw)), neg)
    return out


class TestCoordinatorTelemetry:
    """``tests/test_metrics.py`` TestCoordinatorTelemetry: the same
    cycle requests into both coordinators give equal instruments."""

    def test_cycle_counters_and_cache_hit_miss(self, regs):
        got = {}
        for name, (svc, neg) in _services().items():
            reg = regs[0] if name == "port" else regs[1]
            try:
                meta = neg.EntryMeta("g", "allreduce", "float32", (4,), 0,
                                     False)
                for r in (0, 1):
                    svc._handle(neg.CycleRequest(r, [meta], ack=-1,
                                                 req_id=1),
                                ("127.0.0.1", 0))
                hits = neg.encode_hits([svc._cache_id_of["g"]])
                for r in (0, 1):
                    svc._handle(neg.CycleRequest(r, [], ack=0, req_id=2,
                                                 hits=hits),
                                ("127.0.0.1", 0))
                resp = svc._handle(neg.CycleRequest(
                    0, [], ack=0, req_id=3,
                    hits=neg.encode_hits([999])), ("127.0.0.1", 0))
                assert resp.unknown_ids == (999,)
            finally:
                svc.shutdown()
            names = ("hvd_coordinator_cycles_total",
                     "hvd_response_cache_misses_total",
                     "hvd_response_cache_hits_total",
                     "hvd_response_cache_unknown_ids_total")
            h = reg.histogram("hvd_coordinator_tensors_per_cycle",
                              buckets=jm.COUNT_BUCKETS).labels()
            got[name] = ([reg.counter(n).value for n in names],
                         h.counts, h.count)
        assert got["port"] == got["jax"]
        assert got["port"][0] == [5, 2, 2, 1]
        assert got["port"][2] == 5

    def test_wire_bytes_counter_tracks_encode_decode(self, regs):
        from horovod_tpu_torch.ops import negotiation as neg
        resp = neg.CycleResponse(0, [], (64 << 20, 5.0), False)
        payload = neg.encode_response(resp)
        neg.decode_response(payload)
        fam = regs[0].counter("hvd_response_wire_bytes_total",
                              labels=("direction",))
        assert fam.labels(direction="out").value == len(payload)
        assert fam.labels(direction="in").value == len(payload)

    def test_piggybacked_snapshot_stored_and_aggregated(self, regs):
        reg = regs[0]
        svc, neg = _services(packages=("port",))["port"]
        try:
            reg.rank = 0
            worker = tm.MetricsRegistry(rank=1)
            worker.counter("hvd_negotiation_cycles_total").inc(7)
            snap = worker.snapshot()
            svc._handle(neg.CycleRequest(1, [], ack=-1, req_id=1,
                                         metrics=snap),
                        ("127.0.0.1", 0))
            assert svc.metrics_snapshot_view()[1] is snap
            srv = tm.MetricsServer(
                0, reg.snapshot,
                remote_snapshots_fn=svc.metrics_snapshot_view,
                host="127.0.0.1")
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{srv.port}/metrics.json",
                        timeout=5) as r:
                    data = json.loads(r.read().decode())
            finally:
                srv.close()
            agg = data["aggregate"]
            assert agg["ranks"] == [0, 1]
            assert agg["metrics"]["hvd_negotiation_cycles_total"][
                "values"][0]["value"] == 7
            assert agg["metrics"]["hvd_coordinator_cycles_total"][
                "values"][0]["value"] == 1
        finally:
            svc.shutdown()

    def test_stall_scan_sets_gauge_and_event_then_clears(self, regs):
        got = {}
        for name, (svc, neg) in _services(
                stall_warning_time_seconds=0.05).items():
            reg = regs[0] if name == "port" else regs[1]
            try:
                meta = neg.EntryMeta("slow", "allreduce", "float32", (4,),
                                     0, False)
                svc._submit(0, [meta])  # rank 1 missing
                time.sleep(0.08)
                svc._stall_scan()
                svc._stall_scan()  # one event per tensor
                stalled = (reg.gauge("hvd_stalled_ranks").value,
                           reg.gauge("hvd_coordinator_stalled_tensors")
                           .value)
                evs = [e for e in reg.events() if e["event"] == "stall"]
                svc._submit(1, [meta])
                svc._negotiate()
                svc._stall_scan()
                cleared = (reg.gauge("hvd_stalled_ranks").value,
                           reg.gauge("hvd_coordinator_stalled_tensors")
                           .value)
            finally:
                svc.shutdown()
            assert len(evs) == 1 and evs[0]["waited_s"] >= 0.05
            got[name] = (stalled, cleared, evs[0]["tensor"],
                         evs[0]["missing_ranks"])
        assert got["port"] == got["jax"] == ((1, 1), (0, 0), "slow", [1])


class TestSatelliteInstrumentation:
    """Fusion and chaos counters: the same inputs through both
    packages' planners and injectors give equal instruments."""

    def _fusion(self, regs, sizes, threshold):
        from horovod_tpu.ops import fusion as jf
        from horovod_tpu_torch.ops import fusion as tf
        tb = tf.plan_buckets([torch.zeros(n) for n in sizes], threshold)
        jb = jf.plan_buckets([np.zeros((n,), np.float32) for n in sizes],
                             threshold)
        assert [b.indices for b in tb] == [b.indices for b in jb]
        names = ("hvd_fusion_tensors_total", "hvd_fusion_bytes_total",
                 "hvd_fusion_buckets_total", "hvd_fusion_oversized_total")
        out = []
        for reg in regs:
            h = reg.histogram("hvd_fusion_fill_ratio",
                              buckets=jm.RATIO_BUCKETS).labels()
            out.append(([reg.counter(n).value for n in names], h.counts,
                        h.sum,
                        [{k: v for k, v in e.items()
                          if k not in ("ts_us", "epoch_us")}
                         for e in reg.events()]))
        assert out[0] == out[1]
        return out[0]

    def test_fusion_plan_records_fill_fraction(self, regs):
        counts, _, fill_sum, _ = self._fusion(regs, [10] * 4, 100)
        assert counts[:3] == [4, 160, 2]
        assert fill_sum == pytest.approx(1.6)

    def test_fusion_plan_flags_oversized(self, regs):
        counts, _, _, events = self._fusion(regs, [50, 10, 10], 100)
        assert counts[3] == 1
        (ev,) = [e for e in events if e["event"] == "oversized_tensor"]
        assert ev == {"event": "oversized_tensor", "index": 0,
                      "nbytes": 200, "threshold": 100}
        self._fusion(regs, [50, 10, 10], 0)
        self._fusion(regs, [20, 5], 100)
        assert regs[0].counter("hvd_fusion_oversized_total").value == 1

    def test_fusion_span_per_planning_call(self, regs):
        from horovod_tpu_torch.ops import fusion as tf
        from horovod_tpu_torch.utils import tracing as tt
        tracer = tt.reset(enabled=True, rank=0)
        try:
            tf.plan_buckets([torch.zeros(8), torch.zeros(8)], 1 << 20)
            (span,) = [s for s in tracer.spans() if s["stage"] == "fusion"]
            assert span["attrs"] == {"n_tensors": 2, "threshold": 1 << 20,
                                     "n_buckets": 1, "bytes": 64}
        finally:
            tt.reset()

    def test_chaos_injection_counts(self, regs):
        from horovod_tpu.run import chaos as jc
        from horovod_tpu_torch.run import chaos as tc
        for chaos, reg in ((tc, regs[0]), (jc, regs[1])):
            rules = chaos.parse_spec("negotiation:*:drop_request:1.0",
                                     seed=7)
            inj = chaos.ChaosInjector("negotiation", rules, delay_ms=0)
            assert inj.decide("request", "CycleRequest") == "drop_request"
        vals = [reg.counter("hvd_chaos_injections_total",
                            labels=("fault",))
                .labels(fault="drop_request").value for reg in regs]
        assert vals == [1, 1]
        evs = [[{k: v for k, v in e.items()
                 if k not in ("ts_us", "epoch_us")}
                for e in reg.events() if e["event"] == "chaos_injection"]
               for reg in regs]
        assert evs[0] == evs[1] and evs[0][0]["service"] == "negotiation"


def _two_rank_scrape():
    def fn():
        import json as _json
        import os
        import time
        import urllib.request
        import torch
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.utils import metrics as hm
        hvd.init(device="cpu")
        r = int(os.environ["HVD_PROCESS_ID"])
        for i in range(3):
            hvd.synchronize(hvd.allreduce_async(
                torch.ones(64), average=False, name=f"m{i}"))
        # outlive HVD_METRICS_INTERVAL so the next cycle piggybacks a
        # fresh worker snapshot
        time.sleep(0.3)
        hvd.synchronize(hvd.allreduce_async(torch.ones(64), average=False,
                                            name="late"))
        port = int(os.environ["HVD_METRICS_PORT"]) + r
        deadline = time.monotonic() + 10
        while True:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=5) as resp:
                text = resp.read().decode()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics.json",
                    timeout=5) as resp:
                data = _json.loads(resp.read().decode())
            if r != 0 or len(data["aggregate"].get("ranks", [])) == 2 or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.2)
        parsed = hm.parse_prometheus(text)
        agg = data["aggregate"]["metrics"]

        def value(name):
            return agg.get(name, {"values": [{"value": 0}]})[
                "values"][0]["value"]

        cyc = parsed.get("hvd_negotiation_cycle_seconds",
                         {"samples": []})["samples"]
        buckets = [v for lab, v in cyc if lab.get("__series__") == "bucket"]
        out = {"rank": r, "prom_names": sorted(parsed),
               "agg_ranks": data["aggregate"].get("ranks", []),
               "agg_cycles": value("hvd_negotiation_cycles_total"),
               "coord_cycles": value("hvd_coordinator_cycles_total"),
               "fusion_tensors": value("hvd_fusion_tensors_total"),
               "buckets_monotonic": buckets == sorted(buckets)}
        hvd.shutdown()
        return out
    return fn


class TestTwoRankEndpoints:
    """``tests/test_metrics.py:565`` through the port's ``run()``: a
    two-rank gloo run with HVD_METRICS_PORT serves Prometheus and JSON,
    and rank 0's aggregate covers both ranks (invariants: cycle counts
    depend on timing)."""

    def test_two_rank_scrape_covers_both_ranks(self):
        base = 21100 + (os.getpid() % 1000) * 2
        env = {"HVD_METRICS_PORT": str(base), "HVD_METRICS_INTERVAL": "0.1"}
        results = run(_two_rank_scrape(), num_proc=2, env=env,
                      start_timeout_s=RUN_TIMEOUT_S)
        by_rank = {res["rank"]: res for res in results}
        for res in results:
            assert "hvd_negotiation_cycles_total" in res["prom_names"]
            assert "hvd_collective_bytes_total" in res["prom_names"]
            assert res["buckets_monotonic"]
        r0 = by_rank[0]
        assert r0["agg_ranks"] == [0, 1], r0
        assert "hvd_coordinator_cycles_total" in r0["prom_names"]
        assert r0["coord_cycles"] >= 4
        assert r0["agg_cycles"] > by_rank[1]["agg_cycles"] / 2, results
        # the coordinator plans every fused allreduce: 4 tensors once
        assert r0["fusion_tensors"] >= 4
