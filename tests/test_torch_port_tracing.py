"""The port's tracing plane (``horovod_tpu_torch/utils/tracing.py``)
against the JAX package's, mirroring ``tests/test_tracing.py:35-223``
(span model, flight-recorder rings and dump format, the null tracer, the
SIGTERM dump), the shared clock of the native timeline, and a two-rank
gloo drill whose flight dumps the JAX package's ``tools/hvd_postmortem.py``
reads (``tests/test_tracing.py:286-357``).

Parity is equality where the output is determined by the inputs: the
same span, cycle and event calls through both tracers give the same
flight snapshot once the clock stamps are dropped. The drill holds
invariants, since which cycle orders a tensor depends on timing: the
postmortem stitches a ``(cycle, tensor)`` group of both ranks and names
the held rank and the tensor it never enqueued.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from horovod_tpu.utils import metrics as jm
from horovod_tpu.utils import tracing as jt
from horovod_tpu_torch.run.launch import run
from horovod_tpu_torch.utils import metrics as tm
from horovod_tpu_torch.utils import tracing as tt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import hvd_postmortem  # noqa: E402

RUN_TIMEOUT_S = 120.0
_TIMES = ("start_us", "end_us", "ts_us", "epoch_us", "epoch_us_at_ts0")


@pytest.fixture
def tracer():
    """A live port tracer at rank 3 over a live registry."""
    tm.reset(enabled=True)
    t = tt.reset(enabled=True, rank=3)
    yield t
    tt.reset()
    tm.reset()


def _timeless(obj):
    if isinstance(obj, dict):
        return {k: _timeless(v) for k, v in obj.items()
                if k not in _TIMES and k != "dur_ms"}
    if isinstance(obj, list):
        return [_timeless(v) for v in obj]
    return obj


def _drive(mod, tracer):
    """One sequence of span, cycle and event calls."""
    tid = tracer.new_trace_id("grad_0")
    enq = tracer.span(mod.ENQUEUE, tensor="grad_0", trace_id=tid,
                      op="allreduce")
    enq.close()
    neg = tracer.span(mod.NEGOTIATE, tensor="grad_0", trace_id=tid,
                      parent=enq, enqueue_req=4)
    neg.annotate(cache_hit=False)
    neg.close(cycle=7, cycles_waited=1)
    with tracer.span(mod.EXECUTE, tensor="grad_0", parent=neg,
                     op="allreduce", fused=2) as ex:
        ex.annotate(bytes=4096)
    try:
        with tracer.span(mod.CALLBACK, tensor="grad_0", parent=ex):
            raise RuntimeError("boom")
    except RuntimeError:
        pass
    tracer.span(mod.NEGOTIATE, tensor="stuck", op="allgather")
    tracer.span(mod.FUSION, n_tensors=2).abort(ValueError("lost"))
    tracer.record_cycle(req_id=3, ack=2, n_metas=1, n_hits=0)
    tracer.record_cycle(kind="chaos_injection", fault="drop_response")
    return tracer


class TestParity:
    def test_stage_names_equal(self):
        assert tt.STAGES == jt.STAGES
        assert tt.SERVE_STAGES == jt.SERVE_STAGES
        assert tt.FLIGHT_VERSION == jt.FLIGHT_VERSION

    def test_flight_snapshot_equal(self):
        snaps = []
        for mod, mm in ((tt, tm), (jt, jm)):
            mm.reset(enabled=True)
            try:
                t = _drive(mod, mod.Tracer(rank=3, span_ring=4,
                                           cycle_ring=8))
                snap = t.flight_snapshot("parity")
                snap.pop("memory", None)  # the JAX memory plane's
                snaps.append(_timeless(snap))
                assert t.trace_id_for("grad_0") == "r3.1"
            finally:
                mm.reset()
        assert snaps[0] == snaps[1]
        assert snaps[0]["spans_dropped"] == 1
        json.dumps(snaps[0])

    def test_span_histogram_counts_equal(self):
        counts = []
        for mod, mm in ((tt, tm), (jt, jm)):
            reg = mm.reset(enabled=True)
            try:
                _drive(mod, mod.Tracer(rank=0))
                fam = reg.histogram("hvd_span_seconds", labels=("stage",))
                counts.append({s: fam.labels(stage=s).count
                               for s in mod.STAGES})
            finally:
                mm.reset()
        assert counts[0] == counts[1]


class TestSpanModel:
    def test_trace_ids_mint_and_lookup(self, tracer):
        a = tracer.new_trace_id("grad_0")
        b = tracer.new_trace_id("grad_1")
        assert a == "r3.1" and b == "r3.2"
        assert tracer.trace_id_for("grad_0") == a
        assert tracer.trace_id_for("never_seen") is None
        c = tracer.new_trace_id("grad_0")  # the latest id wins
        assert tracer.trace_id_for("grad_0") == c
        s = tracer.span(tt.NEGOTIATE, tensor="grad_1")
        assert s.trace_id == b
        s.close()

    def test_close_is_idempotent_and_moves_to_ring(self, tracer):
        s = tracer.span(tt.EXECUTE, tensor="t", op="allreduce")
        assert s.open and s in tracer.open_spans()
        s.close(bytes=128)
        s.close(status="error")
        assert s.status == "ok" and tracer.open_spans() == []
        (rec,) = tracer.spans()
        assert rec["attrs"] == {"op": "allreduce", "bytes": 128}
        assert rec["end_us"] >= rec["start_us"]

    def test_abort_and_context_manager(self, tracer):
        with pytest.raises(RuntimeError):
            with tracer.span(tt.FUSION) as s:
                raise RuntimeError("boom")
        assert s.status == "error"
        assert "RuntimeError: boom" in s.attrs["error"]

    def test_parent_links_and_null_parent(self, tracer):
        ex = tracer.span(tt.EXECUTE, tensor="t")
        cb = tracer.span(tt.CALLBACK, tensor="t", parent=ex)
        assert cb.parent_id == ex.span_id
        # a null span as parent (a stage the tracer never opened) links
        # to nothing rather than to an unserializable object
        orphan = tracer.span(tt.CALLBACK, tensor="t", parent=tt._NULL_SPAN)
        assert orphan.parent_id is None
        for s in (orphan, cb, ex):
            s.close()
        json.dumps(tracer.spans())


class TestBatchedSpans:
    """The port's group form of the span calls (``open_many``,
    ``close_many``, ``new_trace_ids``), which the eager core uses for a
    fused group's per-tensor spans: the same records as one call per
    span, but the start and the end stamps shared by the group."""

    def test_same_records_as_single_calls(self):
        tm.reset(enabled=True)
        try:
            recs = []
            for batched in (False, True):
                t = tt.Tracer(rank=1)
                names = ["a", "b", "c"]
                if batched:
                    tids = t.new_trace_ids(names)
                    spans = t.open_many(tt.EXECUTE, [
                        (n, tid, None, {"op": "allreduce"})
                        for n, tid in zip(names, tids)])
                    t.close_many(spans, [{"bytes": i} for i in range(3)],
                                 fused=3)
                else:
                    for i, n in enumerate(names):
                        tid = t.new_trace_id(n)
                        t.span(tt.EXECUTE, tensor=n, trace_id=tid,
                               op="allreduce").close(fused=3, bytes=i)
                recs.append(([_timeless(s) for s in t.spans()],
                             {n: t.trace_id_for(n) for n in names}))
            assert recs[0] == recs[1]
            fam = tm.get_registry().histogram("hvd_span_seconds",
                                              labels=("stage",))
            assert fam.labels(stage=tt.EXECUTE).count == 6
        finally:
            tm.reset()

    def test_close_many_is_idempotent_and_parents_link(self, tracer):
        (enq,) = tracer.open_many(tt.ENQUEUE, [("g", "r3.9", None, {})])
        (neg,) = tracer.open_many(tt.NEGOTIATE, [("g", "r3.9", enq, {})])
        assert neg.parent_id == enq.span_id
        assert len(tracer.open_spans()) == 2
        tracer.close_many([enq, neg, tt._NULL_SPAN], status="error",
                          error="x")
        tracer.close_many([enq], extra=1)  # already closed: left alone
        assert tracer.open_spans() == []
        recs = tracer.spans()
        assert [r["status"] for r in recs] == ["error", "error"]
        assert "extra" not in recs[0].get("attrs", {})

    def test_null_tracer_batches_are_no_ops(self):
        t = tt.NullTracer()
        assert t.new_trace_ids(["a", "b"]) == [None, None]
        spans = t.open_many(tt.FUSION, [("a", None, None, {})])
        assert spans == [tt._NULL_SPAN]
        t.close_many(spans)


class TestFlightRecorder:
    def test_rings_bound_and_count_drops(self):
        t = tt.Tracer(rank=0, span_ring=4, cycle_ring=2)
        for i in range(6):
            t.span(tt.ENQUEUE, tensor=f"t{i}").close()
        assert [r["tensor"] for r in t.spans()] == ["t2", "t3", "t4", "t5"]
        assert t.flight_snapshot()["spans_dropped"] == 2
        for i in range(3):
            t.record_cycle(req_id=i)
        assert [c["req_id"] for c in t.cycles()] == [1, 2]

    def test_dump_writes_file_and_counts(self, tracer, tmp_path):
        tracer._dump_dir = str(tmp_path)
        tracer.span(tt.ENQUEUE, tensor="t").close()
        path = tracer.dump("drill")
        assert path == str(tmp_path / "flight-rank3.json")
        snap = json.load(open(path))
        assert snap["rank"] == 3 and snap["reason"] == "drill"
        assert tm.get_registry().counter(
            "hvd_flight_dumps_total",
            labels=("reason",)).labels(reason="drill").value == 1
        blocker = tmp_path / "file"
        blocker.write_text("")
        assert tracer.dump("x", path=str(blocker / "sub" / "d.json")) \
            is None

    def test_slow_span_event(self):
        tm.reset(enabled=True)
        try:
            t = tt.Tracer(rank=1, slow_ms=0.0)
            t.span(tt.EXECUTE, tensor="big", trace_id="r1.9").close()
            (ev,) = [e for e in tm.get_registry().events()
                     if e["event"] == "slow_span"]
            assert ev["tensor"] == "big" and ev["trace_id"] == "r1.9"
        finally:
            tm.reset()

    def test_write_remote_dump(self, tracer, tmp_path):
        tracer._dump_dir = str(tmp_path)
        path = tt.write_remote_dump({"rank": 5, "spans": []})
        assert path == str(tmp_path / "flight-rank5.json")
        assert tt.write_remote_dump("not a dict") is None
        assert tt.flight_dir() == str(tmp_path)


class TestLifecycle:
    def test_null_tracer_absorbs_everything(self):
        t = tt.reset(enabled=False)
        try:
            s = t.span(tt.ENQUEUE, tensor="x")
            assert s is tt._NULL_SPAN
            assert s.annotate(a=1).close().abort() is s
            with pytest.raises(ValueError):
                with t.span(tt.STEP):
                    raise ValueError("boom")
            assert t.spans() == [] and t.dump("x") is None
            assert t.flight_snapshot()["disabled"] is True
        finally:
            tt.reset()

    def test_env_gate_and_set_rank(self, monkeypatch):
        monkeypatch.setenv("HVD_TRACE", "0")
        assert not tt.reset().enabled
        monkeypatch.setenv("HVD_TRACE", "1")
        t = tt.reset()
        assert t.enabled and t.rank is None
        tt.set_rank(4)
        assert t.new_trace_id().startswith("r4.")
        tt.reset()

    def test_sigterm_dump_chains_and_defers(self, tmp_path):
        """The dump handler chains the previous SIGTERM handler, and
        re-delivers only while it is the outermost disposition
        (subprocesses: a regression kills the victim, not the run)."""
        chained = (
            "import os, signal\n"
            "from horovod_tpu_torch.utils import tracing\n"
            "tracing.reset(enabled=True, rank=2)\n"
            "hits = []\n"
            "signal.signal(signal.SIGTERM, lambda *a: hits.append(a))\n"
            "assert tracing.install_signal_dump()\n"
            "prev = signal.getsignal(signal.SIGTERM)\n"
            "def outer(signum, frame):\n"
            "    hits.append('outer')\n"
            "    prev(signum, frame)\n"
            "signal.signal(signal.SIGTERM, outer)\n"
            "os.kill(os.getpid(), signal.SIGTERM)\n"
            "assert len(hits) == 2, hits\n"
            "print('SURVIVED')\n")
        env = dict(os.environ, HVD_FLIGHT_DIR=str(tmp_path))
        proc = subprocess.run([sys.executable, "-c", chained], env=env,
                              capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
        assert "SURVIVED" in proc.stdout
        snap = json.load(open(tmp_path / "flight-rank2.json"))
        assert snap["reason"] == "sigterm"
        solo = (
            "import os, signal\n"
            "from horovod_tpu_torch.utils import tracing\n"
            "tracing.reset(enabled=True, rank=0)\n"
            "assert tracing.install_signal_dump()\n"
            "os.kill(os.getpid(), signal.SIGTERM)\n")
        proc = subprocess.run([sys.executable, "-c", solo], env=env,
                              capture_output=True, text=True, timeout=60)
        assert proc.returncode == -signal.SIGTERM


class TestSharedClock:
    """The native timeline on the shared clock: its ``ts`` and the
    metrics plane's ``ts_us`` share one base, and its ``clock_sync``
    event carries the shared clock's epoch."""

    def test_timeline_and_metric_events_share_a_base(self, tmp_path):
        from horovod_tpu_torch.utils import timeline
        path = str(tmp_path / "t.json")
        tl = timeline.NativeTimeline(path)
        reg = tm.MetricsRegistry()
        try:
            tl.start_activity("x", timeline.ALLREDUCE)
            ev = reg.event("probe")
            tl.end_activity("x")
        finally:
            tl.close()
        trace = json.load(open(path))
        sync = [e for e in trace if e.get("name") == "clock_sync"]
        assert sync[0]["args"]["epoch_us_at_ts0"] == \
            tm.shared_clock().epoch_us_at_ts0
        (begin,) = [e for e in trace if e.get("ph") == "B"]
        assert abs(begin["ts"] - ev["ts_us"]) <= 1000, (begin, ev)


def _held_rank_job():
    def fn():
        import os
        import time
        import torch
        import horovod_tpu_torch as hvd
        hvd.init(device="cpu")
        r = hvd.rank()
        for i in range(2):
            hvd.allreduce(torch.ones(16), average=False, name=f"a{i}")
        if r == 1:
            time.sleep(float(os.environ["HELD_S"]))  # rank 1 held back
        out = hvd.allreduce(torch.ones(16), average=False, name="held")
        hvd.shutdown()
        return float(out[0])
    return fn


class TestPostmortemOfPortDumps:
    """A two-rank gloo run with rank 1 held back past the stall deadline:
    the coordinator dumps its own ring and solicits rank 1's, and the JAX
    package's postmortem reads the port's dumps."""

    def test_postmortem_names_held_rank_and_tensor(self, tmp_path):
        # HVD_FLIGHT_SIGTERM=0: run()'s launcher SIGTERMs workers still
        # exiting after they reported, and that dump would overwrite the
        # stall's with the finished run's view
        env = {"HVD_FLIGHT_DIR": str(tmp_path),
               "HOROVOD_STALL_CHECK_TIME_SECONDS": "0.3",
               "HVD_FLIGHT_SIGTERM": "0", "HELD_S": "1.5"}
        t0 = time.monotonic()
        assert run(_held_rank_job(), num_proc=2, env=env,
                   start_timeout_s=RUN_TIMEOUT_S) == [2.0, 2.0]
        assert time.monotonic() - t0 < RUN_TIMEOUT_S
        paths = sorted(hvd_postmortem.find_dumps(str(tmp_path)))
        assert [os.path.basename(p) for p in paths] == \
            ["flight-rank0.json", "flight-rank1.json"]
        dumps, bad = hvd_postmortem.load_dumps(paths)
        assert not bad
        hvd_postmortem.rebase(dumps)
        stitched = hvd_postmortem.stitch(dumps)
        both = [k for k, by_rank in stitched.items()
                if sorted(by_rank) == [0, 1]]
        assert {k[1] for k in both} >= {"a0", "a1"}, stitched
        verdict = hvd_postmortem.analyze(dumps)
        assert verdict["divergent_rank"] == 1, verdict
        assert verdict["tensor"] == "held"
        assert verdict["never_enqueued"] == {"held": [1]}
        assert verdict["waiting"] == {"held": [0]}
        assert verdict["trace_id"].startswith("r0.")
        events = {e["event"] for d in dumps for e in d["events"]}
        assert "stall" in events
