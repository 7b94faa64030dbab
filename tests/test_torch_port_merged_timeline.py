"""The port's merged timeline (``horovod_tpu_torch/utils/merged_timeline.py``)
against the JAX package's: ``merge()`` of a synthetic Horovod timeline
and a synthetic ``torch.profiler`` Chrome trace with known epochs equals
the JAX ``merge()`` of the same events re-expressed in its input format
(``plugins/profile/<ts>/*.trace.json.gz`` with the session's epoch
passed in); the trace's own ``baseTimeNanoseconds`` and the fallback
epoch both place the events; ``capture()`` over the port's eager core on
the CPU writes one file with the ALLREDUCE span and the profiler's
events, and ``timeline.profile`` exports a trace.
"""

import gzip
import json
import os

import pytest
import torch

from horovod_tpu.utils import merged_timeline as jmt
from horovod_tpu_torch.utils import merged_timeline as tmt
from horovod_tpu_torch.utils import timeline as ttl

HVD_EPOCH_US = 1_700_000_000_000_000.0
PROF_EPOCH_US = HVD_EPOCH_US - 2_500.0


def _timeline(path):
    lines = ["[",
             json.dumps({"name": "clock_sync", "ph": "M", "pid": 0,
                         "args": {"epoch_us_at_ts0": HVD_EPOCH_US}}) + ",",
             json.dumps({"name": "process_name", "ph": "M", "pid": 1,
                         "args": {"name": "grad.0"}}) + ",",
             json.dumps({"name": "NEGOTIATE_ALLREDUCE", "ph": "B",
                         "pid": 1, "ts": 10}) + ",",
             json.dumps({"name": "", "ph": "E", "pid": 1, "ts": 40}) + ",",
             json.dumps({"name": "ALLREDUCE", "ph": "B", "pid": 1,
                         "ts": 40}) + ",",
             json.dumps({"name": "", "ph": "E", "pid": 1, "ts": 900}) + ",",
             '{"name": "torn']
    path.write_text("\n".join(lines))


PROF = [{"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce",
         "pid": 0, "tid": 13, "ts": 2600.0, "dur": 300.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 99,
         "tid": 99, "ts": 2500.0, "dur": 20.0},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 13,
         "args": {"name": "stream 13"}}]


def _jax_dir(root):
    session = root / "plugins" / "profile" / "2026_10_18"
    session.mkdir(parents=True)
    with gzip.open(session / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": PROF}, f)
    return str(root)


@pytest.mark.parametrize("how", ["explicit", "base", "fallback"])
def test_merge_equals_the_jax_merge(tmp_path, how):
    tl = tmp_path / "timeline.json"
    _timeline(tl)
    jout = tmp_path / "jax.json"
    n_j = jmt.merge(str(tl), _jax_dir(tmp_path / "jax"), str(jout),
                    profiler_epoch_us=PROF_EPOCH_US)
    trace = {"traceEvents": PROF}
    kw = {}
    if how == "explicit":
        kw["profiler_epoch_us"] = PROF_EPOCH_US
    elif how == "base":
        trace["baseTimeNanoseconds"] = int(PROF_EPOCH_US * 1000)
    else:
        # no base: the wall clock at the profiler's start stands for the
        # trace's earliest ts (2500 µs after the epoch here)
        kw["profiler_epoch_us_fallback"] = PROF_EPOCH_US + 2500.0
    tr = tmp_path / "trace.json"
    tr.write_text(json.dumps(trace))
    tout = tmp_path / "port.json"
    n_t = tmt.merge(str(tl), str(tr), str(tout), **kw)
    assert n_t == n_j
    assert json.loads(tout.read_text()) == json.loads(jout.read_text())
    ev = json.loads(tout.read_text())["traceEvents"]
    span = next(e for e in ev if e.get("name") == "ALLREDUCE")
    kern = next(e for e in ev if e.get("name") == "ncclDevKernel_AllReduce")
    # the kernel (epoch + 100 µs .. +400) lies inside the span (+40..+900)
    assert span["ts"] <= kern["ts"] <= span["ts"] + 860


@pytest.mark.parametrize("trace_keeps_its_own", [True, False])
def test_merge_takes_the_device_events_given(tmp_path, trace_keeps_its_own):
    # the device events a live profiler holds, in epoch µs, replace the
    # exported trace's own (or stand in where it lost them): the merged
    # file equals the JAX merge of the trace that held them
    tl = tmp_path / "timeline.json"
    _timeline(tl)
    jout = tmp_path / "jax.json"
    jmt.merge(str(tl), _jax_dir(tmp_path / "jax"), str(jout),
              profiler_epoch_us=PROF_EPOCH_US)
    kept = PROF if trace_keeps_its_own else [
        e for e in PROF if e.get("cat") != "kernel"]
    tr = tmp_path / "trace.json"
    tr.write_text(json.dumps({
        "traceEvents": kept,
        "baseTimeNanoseconds": int(PROF_EPOCH_US * 1000)}))
    device = [dict(e, ts=PROF_EPOCH_US + e["ts"]) for e in PROF
              if e.get("cat") == "kernel"]
    tout = tmp_path / "port.json"
    # the timeline's epoch moved by the shared clock's drift: the same
    # merge as a timeline stamped that much later
    tmt.merge(str(tl), str(tr), str(tout), device_events=device,
              timeline_shift_us=0.0)
    shifted = tmp_path / "shifted.json"
    tmt.merge(str(tl), str(tr), str(shifted), device_events=[
        dict(e, ts=e["ts"] - 250.0) for e in device],
        profiler_epoch_us=PROF_EPOCH_US - 250.0, timeline_shift_us=-250.0)
    assert json.loads(shifted.read_text()) == json.loads(tout.read_text())

    def key(e):
        return json.dumps(e, sort_keys=True)
    assert sorted(map(key, json.loads(tout.read_text())["traceEvents"])) \
        == sorted(map(key, json.loads(jout.read_text())["traceEvents"]))


def test_merge_without_any_epoch_raises(tmp_path):
    tl = tmp_path / "timeline.json"
    _timeline(tl)
    tr = tmp_path / "trace.json"
    tr.write_text(json.dumps({"traceEvents": PROF}))
    with pytest.raises(ValueError, match="epoch"):
        tmt.merge(str(tl), str(tr), str(tmp_path / "out.json"))
    bad = tmp_path / "bad.json"
    bad.write_text("[\n")
    with pytest.raises(ValueError, match="clock_sync"):
        tmt.merge(str(bad), str(tr), str(tmp_path / "out.json"))


@pytest.fixture
def eager_timeline(monkeypatch, tmp_path):
    import horovod_tpu_torch as hvd
    path = tmp_path / "timeline.json"
    monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
    hvd.init(device="cpu")
    yield hvd, path
    hvd.shutdown()


def test_capture_over_the_eager_core(eager_timeline, tmp_path):
    hvd, _ = eager_timeline
    out = tmp_path / "merged.json"
    with tmt.capture(str(out), trace_path=str(tmp_path / "trace.json")):
        for i in range(3):
            hvd.allreduce(torch.full((8, 4), float(i)), average=False,
                          name=f"mt.grad{i}")
    events = json.loads(out.read_text())["traceEvents"]

    def hvd_lane(e):   # the profiler also writes string pids
        pid = e.get("pid", 0)
        return isinstance(pid, int) and pid >= tmt._HVD_PID_BASE
    hvd_spans = [e for e in events if hvd_lane(e)]
    names = {e.get("name") for e in hvd_spans}
    assert {"NEGOTIATE_ALLREDUCE", "ALLREDUCE"} <= names
    prof = [e for e in events if not hvd_lane(e) and e.get("ph") == "X"]
    assert prof
    assert all(e["ts"] >= 0 for e in events if "ts" in e)
    hvd_ts = [e["ts"] for e in hvd_spans if "ts" in e]
    prof_ts = [e["ts"] for e in prof]
    assert min(hvd_ts) < max(prof_ts) + 1e6
    assert min(prof_ts) < max(hvd_ts) + 1e6
    with pytest.raises(ZeroDivisionError):
        with tmt.capture(str(tmp_path / "aborted.json")):
            1 / 0
    assert not (tmp_path / "aborted.json").exists()


def test_capture_without_a_timeline_raises(tmp_path):
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        with pytest.raises(RuntimeError, match="HOROVOD_TIMELINE"):
            with tmt.capture(str(tmp_path / "m.json")):
                pass
    finally:
        hvd.shutdown()


def test_timeline_profile_exports_a_trace(tmp_path):
    with ttl.profile(str(tmp_path / "prof")):
        torch.randn(8, 8).sum()
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert trace["traceEvents"]


def test_merge_writes_the_capture_device_records(tmp_path):
    # the count of launches the profiler kept no device event for goes
    # into the merged file as one metadata event, and changes nothing else
    tl = tmp_path / "timeline.json"
    _timeline(tl)
    tr = tmp_path / "trace.json"
    tr.write_text(json.dumps({
        "traceEvents": PROF,
        "baseTimeNanoseconds": int(PROF_EPOCH_US * 1000)}))
    plain, counted = tmp_path / "plain.json", tmp_path / "counted.json"
    n = tmt.merge(str(tl), str(tr), str(plain))
    records = {"launches": 3, "unrecorded": 1}
    assert tmt.merge(str(tl), str(tr), str(counted),
                     device_records=records) == n + 1
    ev = json.loads(counted.read_text())["traceEvents"]
    meta = [e for e in ev if e.get("name") == "device_records"]
    assert meta == [{"name": "device_records", "ph": "M",
                     "pid": tmt._HVD_PID_BASE, "args": records}]
    assert [e for e in ev if e not in meta] == \
        json.loads(plain.read_text())["traceEvents"]
