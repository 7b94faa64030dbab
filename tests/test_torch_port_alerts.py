"""The port's alerting plane (``horovod_tpu_torch/utils/alerts.py``)
against the JAX package's, mirroring ``tests/test_alerts.py``.

Parity is equality: the same rules fed the same registry values at the
same virtual ``now`` give the same transitions (the lifecycle events, the
state gauge, the transition counters and the states at every tick), and
an incident file with the same fields. No real time is involved.
"""

import json

import pytest

from horovod_tpu.utils import alerts as ja
from horovod_tpu.utils import history as jh
from horovod_tpu.utils import metrics as jm
from horovod_tpu_torch.utils import alerts as ta
from horovod_tpu_torch.utils import history as th
from horovod_tpu_torch.utils import metrics as tm

PKGS = {"port": (ta, th, tm, "horovod_tpu_torch"),
        "jax": (ja, jh, jm, "horovod_tpu")}
_TIMES = ("ts_us", "epoch_us", "fired_epoch_us", "window_start_epoch_us",
          "unix_ms", "run_id", "path")


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in _TIMES}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


@pytest.fixture
def no_dump(monkeypatch):
    """Hermetic escalation: both packages' flight dumps are captured."""
    reasons = {"port": [], "jax": []}
    for name, (_, _, _, pkg) in PKGS.items():
        monkeypatch.setattr(f"{pkg}.utils.tracing.dump_on_failure",
                            reasons[name].append)
    return reasons


def _manager(alerts, hist, reg, rules, tmp_path, **kw):
    kw.setdefault("interval_s", 0.0)
    kw.setdefault("incident_dir", str(tmp_path))
    kw.setdefault("history_writer", hist.NullHistoryWriter())
    return alerts.AlertManager(registry=reg, rules=rules, **kw)


def _goodput_traffic(alerts, hist, met, tmp_path):
    """The default pack's goodput-burn rule through a healthy stretch,
    a 50 % waste spike and a recovery, ticking at 1 s."""
    reg = met.MetricsRegistry(rank=0)
    good = reg.counter("hvd_serve_goodput_tokens_total")
    bad = reg.counter("hvd_serve_wasted_tokens_total")
    rules = [r for r in alerts.default_rules()
             if r.name == "serve_goodput_burn"]
    mgr = _manager(alerts, hist, reg, rules, tmp_path)
    states, now = [], 0.0
    for phase in ([(100, 0)] * 100, [(50, 50)] * 40, [(100, 0)] * 40):
        for g, b in phase:
            good.inc(g)
            if b:
                bad.inc(b)
            mgr.tick(now=now)
            states.append(mgr.states())
            now += 1.0
    return reg, mgr, states


def _lifecycle(alerts, hist, met, tmp_path, breaches):
    """One rule with for 5 s / clear 10 s through a breach sequence."""
    reg = met.MetricsRegistry(rank=0)
    box = [False]
    rule = alerts.Rule("t_rule", lambda view: (box[0], {"v": 1}),
                       for_s=5.0, clear_s=10.0)
    mgr = _manager(alerts, hist, reg, [rule], tmp_path)
    out = []
    for now, breach in breaches:
        box[0] = breach
        mgr.tick(now=now)
        out.append((now, mgr.states()["t_rule"]["state"]))
    return reg, mgr, out


class TestTransitionParity:
    def test_goodput_burn_same_transitions(self, tmp_path, no_dump,
                                           monkeypatch):
        monkeypatch.setenv("HVD_ALERT_FOR_S", "5.0")
        got = {}
        for name, (alerts, hist, met, _) in PKGS.items():
            d = tmp_path / name
            d.mkdir()
            reg, mgr, states = _goodput_traffic(alerts, hist, met, d)
            got[name] = (states, _strip(reg.events()),
                         _strip(reg.snapshot(max_events=0)["metrics"]),
                         len(mgr.incidents))
        assert got["port"] == got["jax"]
        kinds = [e["event"] for e in got["port"][1]]
        assert kinds == ["alert_pending", "alert_firing", "alert_incident",
                         "alert_resolved"]
        assert no_dump["port"] == no_dump["jax"] == \
            ["alert:serve_goodput_burn"]

    def test_lifecycle_with_hysteresis_same_transitions(self, tmp_path,
                                                        no_dump):
        seq = [(0.0, True), (2.0, False), (3.0, True), (8.0, True),
               (9.0, False), (12.0, True), (13.0, False), (20.0, False),
               (23.0, False), (24.0, True), (30.0, True)]
        got = {}
        for name, (alerts, hist, met, _) in PKGS.items():
            d = tmp_path / name
            d.mkdir()
            reg, mgr, states = _lifecycle(alerts, hist, met, d, seq)
            got[name] = (states, _strip(reg.events()),
                         _strip(reg.snapshot(max_events=0)["metrics"]))
        assert got["port"] == got["jax"]
        assert [s for _, s in got["port"][0]] == [
            "pending", "inactive", "pending", "firing", "firing", "firing",
            "firing", "firing", "inactive", "pending", "firing"]

    def test_default_pack_same_rules_and_verdicts(self, tmp_path, no_dump):
        got = {}
        for name, (alerts, hist, met, _) in PKGS.items():
            reg = met.MetricsRegistry(rank=0)
            mgr = _manager(alerts, hist, reg, alerts.default_rules(),
                           tmp_path / name)
            mgr.tick(now=0.0)
            before = mgr.states()
            reg.gauge("hvd_stalled_ranks").set(2)
            h = reg.histogram("hvd_serve_ttft_seconds",
                              buckets=(0.5, 1.0, 2.0, 4.0))
            for _ in range(10):
                h.labels().observe(3.5)
            mgr.tick(now=1.0)
            got[name] = (before, mgr.states(),
                         [(r.name, r.severity, r.for_s, r.description)
                          for r in mgr.rules])
        assert got["port"] == got["jax"]
        states = got["port"][1]
        assert states["stall"]["state"] == "pending"
        assert states["serve_ttft_p99"]["state"] == "pending"
        # a metric the port does not emit yet never breaches
        assert states["hbm_headroom_low"]["state"] == "inactive"
        assert states["nonfinite_burst"]["state"] == "inactive"

    def test_incident_file_same_fields(self, tmp_path, no_dump):
        got = {}
        for name, (alerts, hist, met, _) in PKGS.items():
            d = tmp_path / name
            d.mkdir()
            reg = met.MetricsRegistry(rank=0)
            writer = hist.HistoryWriter(str(d), registry=reg,
                                        interval_s=3600.0)
            try:
                reg.event("serve_admit", request_id="req-1")
                reg.event("serve_admit", request_id="req-2")
                reg.event("serve_retire", request_id="req-1",
                          phase_ms={"prefill": 30.0, "decode": 120.0},
                          trace_id="tr-9")
                writer.flush(wait=True)
                rule = alerts.Rule("t_inc",
                                   lambda view: (True, {"why": "drill"}),
                                   for_s=0.0, severity="page")
                mgr = _manager(alerts, hist, reg, [rule], d,
                               history_writer=writer)
                mgr.tick(now=0.0)
            finally:
                writer.close()
            (path,) = mgr.incidents
            inc = json.load(open(path))
            got[name] = inc
        t, j = got["port"], got["jax"]
        assert sorted(t) == sorted(j)
        for key in ("alert", "severity", "description", "episode",
                    "pending_for_s", "evidence", "dominant_phase",
                    "phase_ms", "request_ids", "trace_ids",
                    "stranded_request_ids"):
            assert t[key] == j[key], key
        assert _strip(t["events"]) == _strip(j["events"])
        assert t["stranded_request_ids"] == ["req-2"]
        assert t["dominant_phase"] == "decode"
        assert t["history"] and t["manifest"]["provenance"]


class TestPortAlerts:
    """``tests/test_alerts.py``'s unit cases on the port."""

    def test_burn_rate_and_rolling_window(self):
        assert ta.burn_rate(0, 0, 0.9) == 0.0
        assert ta.burn_rate(90, 10, 0.9) == pytest.approx(1.0)
        assert ta.burn_rate(99, 1, 1.0) == float("inf")

        class Acc:
            def __init__(self):
                self.vals = []

            def observe(self, v):
                self.vals.append(v)

            @property
            def n(self):
                return len(self.vals)

        w = ta.RollingWindow(4, Acc)
        for v in (1, 2, 3, 4, 5):
            w.observe(v)
        assert w.last_full.vals == [1, 2, 3, 4]
        assert w.recent().vals == [5]
        assert w.freeze().vals == [1, 2, 3, 4]

    def test_rule_view_windows(self):
        reg = tm.MetricsRegistry(rank=0)
        reg.counter("t_c").inc(10)
        sampler = ta._Sampler()
        sampler.add(40.0, 2.0)
        sampler.add(65.0, 6.0)
        view = ta.RuleView(reg.snapshot(max_events=0),
                           {("v", "t_c", ta._labels_key(None)): sampler},
                           100.0)
        assert view.delta("t_c", 30.0) == 4.0
        assert view.delta("t_c", 70.0) == 8.0
        assert view.quantile("t_missing", 0.5) is None

    def test_broken_predicate_is_isolated(self, tmp_path, no_dump):
        reg = tm.MetricsRegistry(rank=0)

        def boom(view):
            raise RuntimeError("predicate bug")

        rules = [ta.Rule("t_boom", boom, for_s=0.0),
                 ta.Rule("t_ok", lambda v: (True, {}), for_s=0.0)]
        mgr = _manager(ta, th, reg, rules, tmp_path)
        mgr.tick(now=0.0)
        assert mgr.firing() == ["t_ok"]

    def test_reset_disabled_is_inert(self, monkeypatch):
        try:
            mgr = ta.reset(enabled=False)
            assert not mgr.enabled
            ta.tick()
            assert mgr.firing() == [] and mgr.states() == {}
            monkeypatch.setenv("HVD_ALERT", "0")
            assert not ta.reset().enabled
        finally:
            ta.reset(enabled=False)
