"""Request-path tracing of the port's serving plane
(``horovod_tpu_torch/serving/tracing.py`` and its calls in the queue and
the engine), mirroring ``tests/test_serve_tracing.py:84-395``.

Parity is equality on a fake clock: the same request events through the
JAX package's ``RequestTrace`` and the port's give identical ``phase_ms``
and identical span records. On the port's ``ServeEngine`` (CPU, tiny
fp32) the times are real, so the tests hold invariants: every result
carries a trace id and phases that sum to the request's total (its
root span's duration, less the microseconds between the decomposition's
read and the span's close), the events and goodput counters
agree with the results, and the JAX package's ``tools/hvd_slo.py`` and
``tools/hvd_postmortem.py`` read the port's flight dump.
"""

import os
import sys
import time

import pytest
import torch

from horovod_tpu.serving import tracing as jst
from horovod_tpu.utils import tracing as jt
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.serving import tracing as tst
from horovod_tpu_torch.serving.engine import ServeEngine
from horovod_tpu_torch.serving.queue import AdmissionQueue, Request
from horovod_tpu_torch.utils import metrics as tm
from horovod_tpu_torch.utils import tracing as tt

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import hvd_postmortem  # noqa: E402
import hvd_slo  # noqa: E402


@pytest.fixture
def reg():
    """Live port registry and tracer, torn down to the env defaults."""
    r = tm.reset(enabled=True)
    tt.reset(enabled=True, rank=0)
    yield r
    tt.reset()
    tm.reset()


class FakeUsClock:
    """Deterministic microsecond clock with the tracer's interface."""

    def __init__(self):
        self.now_us = 0.0
        self.epoch_us_at_ts0 = 1_700_000_000_000_000

    def ts_us(self):
        return self.now_us

    def epoch_us(self, ts_us=None):
        return self.epoch_us_at_ts0 + (
            self.now_us if ts_us is None else ts_us)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _lifecycle(serve_mod, trace_mod, requeues, ticks, stall_us, outcome):
    """One request's events on a fake clock through one package."""
    tracer = trace_mod.Tracer(rank=0, clock=FakeUsClock())
    clock = tracer.clock
    t = serve_mod.RequestTrace(tracer, "r0").on_submit()
    clock.now_us += 5_000
    t.on_pop()
    for _ in range(requeues):
        t.on_requeue()
        clock.now_us += 3_000
        t.on_pop()
    if outcome == "rejected":
        t.on_requeue()
        clock.now_us += 1_500
        phases = t.on_reject("deadline")
    else:
        t.on_prefill_start(slot=1, prompt_len=4)
        clock.now_us += 7_000
        t.on_prefill_end(ttft_s=0.012)
        for dur in ticks:
            clock.now_us += dur
            t.on_decode_tick(dur)
        clock.now_us += stall_us
        phases = t.on_retire(outcome, tokens=len(ticks) + 1)
    return phases, tracer.spans(), tracer.open_spans()


class TestRequestTraceParity:
    @pytest.mark.parametrize("requeues,ticks,stall_us,outcome", [
        (2, (4_000, 4_000), 2_000, "completed"),
        (0, (1_234, 5_678, 91), 17, "completed"),
        (1, (250,), 0, "failed"),
        (3, (), 0, "rejected"),
    ])
    def test_identical_phase_ms_and_spans(self, requeues, ticks, stall_us,
                                          outcome):
        port = _lifecycle(tst, tt, requeues, ticks, stall_us, outcome)
        ref = _lifecycle(jst, jt, requeues, ticks, stall_us, outcome)
        assert port[0] == ref[0]
        assert port[1] == ref[1]
        assert port[2] == ref[2] == []
        assert tst.PHASES == jst.PHASES

    def test_exact_decomposition(self):
        phases, spans, _ = _lifecycle(tst, tt, 2, (4_000, 4_000), 2_000,
                                      "completed")
        assert phases == {"queue_wait": 5.0, "requeue": 6.0,
                          "prefill": 7.0, "decode": 8.0,
                          "scheduler_stall": 2.0}
        (root,) = [s for s in spans if s["stage"] == tt.REQUEST]
        assert root["attrs"]["phase_ms"] == phases
        assert root["attrs"]["requeues"] == 2

    def test_crash_mid_request_leaves_open_spans(self):
        tracer = tt.Tracer(rank=0, clock=FakeUsClock())
        t = tst.RequestTrace(tracer, "r0").on_submit()
        t.on_pop()
        t.on_prefill_start(slot=0, prompt_len=2)
        t.on_prefill_end()
        assert {tt.REQUEST, tt.DECODE} <= \
            {s.stage for s in tracer.open_spans()}


class TestBeginAndQueue:
    def test_begin_attaches_once_and_replaces_closed(self, reg,
                                                     monkeypatch):
        req = Request("a", (1, 2))
        t1 = tst.begin(req)
        assert tst.begin(req) is t1
        t1.on_pop()
        t1.on_retire("completed")
        assert tst.begin(req) is not t1
        monkeypatch.setenv("HVD_SERVE_TRACE", "0")
        other = Request("b", (1,))
        assert tst.begin(other) is tst._NULL_TRACE
        assert tst.trace_of(Request("c", (1,))) is tst._NULL_TRACE

    def test_queue_drives_wait_spans_and_rejects(self, reg):
        q = AdmissionQueue(max_depth=1, admission_timeout_s=10.0)
        req = Request("a", (1, 2))
        assert q.submit(req)
        rej = Request("b", (1,))
        assert not q.submit(rej)
        assert tst.trace_of(rej).closed
        assert q.rejected["queue_full"] == 1
        (ev,) = [e for e in reg.events() if e["event"] == "serve_reject"]
        assert ev["trace_id"] == tst.trace_of(rej).trace_id
        assert q.pop() is req
        q.requeue(req)
        assert tst.trace_of(req).requeues == 1
        q.pop()
        tst.trace_of(req).on_retire("completed")
        waits = [s for s in tt.get_tracer().spans()
                 if s["stage"] == tt.QUEUE_WAIT and s["tensor"] == "a"]
        assert [bool((s.get("attrs") or {}).get("requeue"))
                for s in waits] == [False, True]
        assert reg.counter("hvd_serve_requests_total",
                           labels=("outcome",)).labels(
            outcome="rejected").value == 1

    def test_deadline_reject_closes_trace(self, reg):
        clock = FakeClock()
        q = AdmissionQueue(max_depth=8, admission_timeout_s=5.0,
                           clock=clock)
        stale = Request("stale", (1,), deadline_s=1.0)
        q.submit(stale)
        clock.t = 2.0
        assert q.pop() is None
        (root,) = [s for s in tt.get_tracer().spans()
                   if s["stage"] == tt.REQUEST]
        assert root["attrs"]["reason"] == "deadline"


def _tiny():
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32,
                                     attention_impl="full")
    return cfg, ttr.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")


def _engine(cfg, model, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("kv_block", 4)
    kw.setdefault("queue", AdmissionQueue(max_depth=64,
                                          admission_timeout_s=1e9))
    return ServeEngine(cfg, model, device="cpu", **kw)


def _sums_to_total(res, spans):
    (root,) = [s for s in spans if s["stage"] == tt.REQUEST and
               s["tensor"] == res.request_id and
               s["trace_id"] == res.trace_id]
    total_ms = (root["end_us"] - root["start_us"]) / 1e3
    # the decomposition reads its total just before the root span
    # closes, so the phases (each rounded to 3 decimals) sum to the
    # root's duration less the few microseconds between the two reads
    gap = total_ms - sum(res.phase_ms.values())
    assert -0.003 <= gap < 1.0, (res.phase_ms, total_ms)


class TestEngineIntegration:
    def test_results_carry_trace_id_and_phases(self, reg):
        cfg, model = _tiny()
        engine = _engine(cfg, model)
        for rid, prompt in (("a", (3, 1, 4)), ("b", (2, 7, 1, 8, 2))):
            engine.submit(Request(rid, prompt, max_new_tokens=5))
        results = engine.run_to_completion()
        assert sorted(r.request_id for r in results) == ["a", "b"]
        spans = tt.get_tracer().spans()
        for res in results:
            assert res.outcome == "completed" and res.trace_id
            assert set(res.phase_ms) == set(tst.PHASES)
            assert res.phase_ms["prefill"] > 0
            assert res.phase_ms["decode"] > 0
            _sums_to_total(res, spans)
        snap = reg.snapshot()
        fam = snap["metrics"]["hvd_serve_phase_seconds"]
        assert {v["labels"]["phase"]: v["count"]
                for v in fam["values"]} == {p: 2 for p in tst.PHASES}
        admits = {e["request_id"]: e["trace_id"] for e in snap["events"]
                  if e["event"] == "serve_admit"}
        retires = {e["request_id"]: e for e in snap["events"]
                   if e["event"] == "serve_retire"}
        for res in results:
            assert admits[res.request_id] == res.trace_id
            assert retires[res.request_id]["phase_ms"] == res.phase_ms
        # all met: prefill + decode tokens are goodput
        assert reg.counter("hvd_serve_goodput_tokens_total").value == \
            3 + 5 + 5 + 5
        assert reg.gauge("hvd_serve_goodput_ratio").value == 1.0
        ttft = reg.histogram("hvd_serve_ttft_seconds").labels()
        assert ttft.count == 2
        tokens = reg.counter("hvd_serve_tokens_total", labels=("phase",))
        assert tokens.labels(phase="decode").value == 10

    def test_deadline_failure_counts_wasted_tokens(self, reg):
        cfg, model = _tiny()
        clock = FakeClock()
        queue = AdmissionQueue(max_depth=8, admission_timeout_s=1e9,
                               clock=clock)
        engine = _engine(cfg, model, queue=queue, clock=clock)
        engine.submit(Request("slow", (1, 2), max_new_tokens=20,
                              deadline_s=5.0))
        engine.step()
        clock.t = 6.0
        (res,) = engine.run_to_completion()
        assert res.outcome == "failed" and res.reason == "deadline"
        assert reg.counter("hvd_serve_wasted_tokens_total",
                           labels=("reason",)).labels(
            reason="deadline").value > 0
        assert reg.gauge("hvd_serve_goodput_ratio").value == 0.0

    def test_kv_pressure_requeues_are_traced(self, reg):
        cfg, model = _tiny()
        engine = _engine(cfg, model, num_slots=2, max_len=16, kv_block=8,
                         total_blocks=2)
        engine.submit(Request("a", tuple(range(1, 9)), max_new_tokens=4))
        engine.submit(Request("b", tuple(range(1, 9)), max_new_tokens=4))
        results = {r.request_id: r for r in engine.run_to_completion()}
        assert results["b"].phase_ms["requeue"] > 0
        roots = {s["tensor"]: s for s in tt.get_tracer().spans()
                 if s["stage"] == tt.REQUEST}
        assert roots["b"]["attrs"]["requeues"] >= 1
        assert roots["a"]["attrs"]["requeues"] == 0

    def test_flight_dump_names_inflight_requests(self, reg):
        cfg, model = _tiny()
        engine = _engine(cfg, model)
        engine.submit(Request("stuck", (1, 2, 3), max_new_tokens=40))
        engine.step()
        engine.step()
        dump = tt.get_tracer().flight_snapshot("unit_test")
        records = hvd_slo.requests_from_dumps([dump])
        (rec,) = [r for r in records if r["request_id"] == "stuck"]
        assert rec["inflight"] and rec["phase_ms"]["prefill"] > 0
        hvd_postmortem.rebase([dump])
        verdict = hvd_postmortem.analyze([dump])
        assert verdict["inflight_requests"] == ["stuck"]
        engine.run_to_completion()

    def test_tracing_off_engine_still_serves(self, reg, monkeypatch):
        monkeypatch.setenv("HVD_SERVE_TRACE", "0")
        cfg, model = _tiny()
        engine = _engine(cfg, model)
        engine.submit(Request("a", (3, 1, 4), max_new_tokens=5))
        (res,) = engine.run_to_completion()
        assert res.outcome == "completed"
        assert res.trace_id is None and res.phase_ms is None


class TestSloDigestOfPortDumps:
    """``tools/hvd_slo.py`` on the port's flight dump: an injected slow
    prefill owns the tail, and a KV-pressure requeue is named."""

    def test_delayed_prefill_dominates_tail(self, reg, monkeypatch):
        from horovod_tpu_torch.serving import engine as engine_mod
        cfg, model = _tiny()
        engine = _engine(cfg, model)
        # untimed warmup: first calls must not pollute the phases
        engine.submit(Request("warm-a", (1, 2, 3), max_new_tokens=4))
        engine.submit(Request("warm-b", (1, 2, 3, 4, 5), max_new_tokens=4))
        engine.run_to_completion()
        tt.reset(enabled=True, rank=0)
        real = engine_mod.prefill_forward

        def delayed(cfg_, params, tokens):
            if tokens.shape[1] > 4:  # the 5-token prompts pad to 8
                # well above what a loaded CPU takes for a request's
                # decode ticks, so that the injected phase dominates
                time.sleep(1.0)
            return real(cfg_, params, tokens)

        monkeypatch.setattr(engine_mod, "prefill_forward", delayed)
        results = []
        for rid, prompt in [("fast-0", (1, 2, 3)), ("fast-1", (1, 2, 3)),
                            ("slow-0", (1, 2, 3, 4, 5)),
                            ("fast-2", (1, 2, 3)),
                            ("slow-1", (1, 2, 3, 4, 5)),
                            ("fast-3", (1, 2, 3))]:
            engine.submit(Request(rid, prompt, max_new_tokens=2))
            results.extend(engine.run_to_completion())
        assert len(results) == 6
        dump = tt.get_tracer().flight_snapshot("drill")
        verdict = hvd_slo.analyze_serve([dump], pct=70)
        assert verdict["requests"] == 6
        assert {r["request_id"] for r in verdict["tail"]} == \
            {"slow-0", "slow-1"}
        assert verdict["dominant_phase"] == "prefill"
        assert not verdict["kv_pressure"]

    def test_kv_pressure_requeue_dominates_tail(self, reg):
        cfg, model = _tiny()
        engine = _engine(cfg, model, num_slots=2, max_len=16, kv_block=8,
                         total_blocks=2)
        engine.submit(Request("warm", tuple(range(1, 9)), max_new_tokens=4))
        engine.run_to_completion()
        tt.reset(enabled=True, rank=0)
        engine.submit(Request("a", tuple(range(1, 9)), max_new_tokens=8))
        engine.submit(Request("b", tuple(range(1, 9)), max_new_tokens=2))
        results = engine.run_to_completion()
        assert all(r.outcome == "completed" for r in results)
        dump = tt.get_tracer().flight_snapshot("drill")
        verdict = hvd_slo.analyze_serve([dump], pct=50)
        (tail,) = verdict["tail"]
        assert tail["request_id"] == "b" and tail["requeues"] >= 1
        assert verdict["kv_pressure"]
        assert "KV pressure" in verdict["verdict"]
