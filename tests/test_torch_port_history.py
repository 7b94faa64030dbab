"""The port's run history (``horovod_tpu_torch/utils/history.py``)
against the JAX package's, mirroring ``tests/test_history.py``.

Parity is equality: the port writes segments that the JAX readers read,
and the JAX package writes segments that the port's readers read, with
``series()`` of each metric, the event stream and the rematerialized
states equal both ways (clock stamps aside). The writer's own behavior
(full then delta records, exact-once events, torn tails, rotation and
pruning, the manifest, writer death) is mirrored on the port.
"""

import json
import shutil

import pytest

from horovod_tpu.utils import history as jh
from horovod_tpu.utils import metrics as jm
from horovod_tpu_torch.utils import history as th
from horovod_tpu_torch.utils import metrics as tm

PAIRS = {"port": (th, tm), "jax": (jh, jm)}


def _writer(hist, path, reg, **kw):
    kw.setdefault("interval_s", 3600.0)  # only explicit flushes record
    return hist.HistoryWriter(str(path), registry=reg, **kw)


def _run(hist, met, path):
    """One seeded run: counters, a labeled gauge, a histogram and events
    across five flushes."""
    reg = met.MetricsRegistry(rank=0)
    c = reg.counter("t_tokens")
    g = reg.gauge("t_hbm", labels=("chip",))
    h = reg.histogram("t_lat", buckets=met.LATENCY_BUCKETS)
    w = _writer(hist, path, reg)
    try:
        for i in range(5):
            c.inc(10 + i)
            g.labels(chip=str(i % 2)).set(float(i))
            h.observe(0.001 * (i + 1))
            reg.event("phase", name=f"p{i}")
            w.flush(wait=True)
    finally:
        w.close()
    return reg


def _views(hist, path):
    records, torn = hist.read_records(str(path), rank=0)
    events, missed = hist.read_events(records)
    states = [s["metrics"] for s in hist.iter_states(records)]
    return {
        "torn": torn, "missed": missed,
        "kinds": [r["t"] for r in records],
        "series": [[v for _, v in hist.series(records, name)]
                   for name in ("t_tokens", "t_lat")],
        "chip0": [v for _, v in hist.series(records, "t_hbm",
                                            labels={"chip": "0"})],
        "events": [e["name"] for e in events if e["event"] == "phase"],
        "states": [{k: v for k, v in s.items()
                    if not k.startswith("hvd_history")} for s in states],
    }


class TestCrossPackageReaders:
    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_readers_agree_on_either_packages_segments(self, tmp_path,
                                                       writer):
        hist, met = PAIRS[writer]
        _run(hist, met, tmp_path)
        port_view, jax_view = _views(th, tmp_path), _views(jh, tmp_path)
        assert port_view == jax_view
        assert port_view["kinds"] == ["full"] + ["delta"] * 5
        assert port_view["series"][0] == [10, 21, 33, 46, 60, 60]
        assert port_view["events"] == [f"p{i}" for i in range(5)]

    def test_both_writers_give_the_same_series(self, tmp_path):
        views = []
        for name, (hist, met) in PAIRS.items():
            d = tmp_path / name
            d.mkdir()
            _run(hist, met, d)
            views.append(_views(th, d))
        assert views[0] == views[1]

    def test_torn_last_line_is_skipped_both_ways(self, tmp_path):
        _run(th, tm, tmp_path)
        seg = tmp_path / "history-rank0-000000.jsonl"
        with open(seg, "a") as f:
            f.write('{"v": 1, "t": "delta", "seq": 6, "metr')
        for hist in (th, jh):
            records, torn = hist.read_records(str(tmp_path), rank=0)
            assert torn == 1
            assert [r["seq"] for r in records] == list(range(6))

    def test_manifests_read_both_ways(self, tmp_path):
        _run(th, tm, tmp_path)
        man = jh.load_manifest(str(tmp_path))
        assert man == th.load_manifest(str(tmp_path))
        assert man["version"] == jh.HISTORY_VERSION
        prov = man["provenance"]
        for key in ("unix_ms", "platform", "device_kind", "device_count"):
            assert key in prov
        assert prov["platform"] in ("cpu", "gpu")
        assert jh.list_ranks(str(tmp_path)) == [0]


class TestWriter:
    """``tests/test_history.py`` on the port's writer."""

    def test_untouched_family_drops_out_of_deltas(self, tmp_path):
        reg = tm.MetricsRegistry(rank=0)
        c = reg.counter("t_steps")
        reg.gauge("t_idle").set(5.0)
        w = _writer(th, tmp_path, reg)
        try:
            w.flush(wait=True)
            c.inc()
            w.flush(wait=True)
        finally:
            w.close()
        records, _ = th.read_records(str(tmp_path), rank=0)
        full, delta = records[0], records[1]
        assert "t_idle" in full["metrics"]
        assert "t_idle" not in delta["metrics"]
        assert "t_steps" in delta["metrics"]

    def test_ring_overflow_is_counted_as_missed(self, tmp_path):
        reg = tm.MetricsRegistry(rank=0)
        w = _writer(th, tmp_path, reg)
        try:
            n = tm.MetricsRegistry.EVENT_RING + 40
            for i in range(n):
                reg.event("burst", i=i)
            w.flush(wait=True)
            w.flush(wait=True)  # nothing new: no duplicate events
        finally:
            w.close()
        records, _ = jh.read_records(str(tmp_path), rank=0)
        events, missed = jh.read_events(records)
        assert missed == 40
        bursts = [e for e in events if e["event"] == "burst"]
        assert len(bursts) == tm.MetricsRegistry.EVENT_RING
        assert bursts[-1]["i"] == n - 1

    def test_rotation_and_pruning(self, tmp_path):
        reg = tm.MetricsRegistry(rank=0)
        fam = reg.gauge("t_bulk", labels=("k",))
        kids = [fam.labels(k=f"key-{i:04d}") for i in range(120)]
        w = _writer(th, tmp_path, reg, max_mb=0.001)
        try:
            for step in range(40):
                for kid in kids:
                    kid.set(float(step))
                w.flush(wait=True)
        finally:
            w.close()
        segs = sorted(p.name for p in tmp_path.glob("history-rank0-*.jsonl"))
        assert 2 <= len(segs) <= th.SEGMENTS_KEPT
        assert "history-rank0-000000.jsonl" not in segs
        for name in segs:
            first = json.loads((tmp_path / name).read_text().splitlines()[0])
            assert first["t"] == "full"
        assert w._m_rot.value >= 1
        records, torn = jh.read_records(str(tmp_path), rank=0)
        states = list(jh.iter_states(records))
        assert torn == 0
        assert states[-1]["metrics"]["t_bulk"]["values"][0]["value"] == 39.0

    def test_annotate_and_nonzero_rank(self, tmp_path):
        w = _writer(th, tmp_path, tm.MetricsRegistry(rank=0))
        try:
            started = th.load_manifest(str(tmp_path))
            w.annotate(label="drill-a", fleet="canary")
        finally:
            w.close()
        man = th.load_manifest(str(tmp_path))
        assert man["fleet"] == "canary"
        assert man["provenance"]["label"] == "drill-a"
        assert man["run_id"] == started["run_id"]
        other = tmp_path / "r1"
        w1 = _writer(th, other, tm.MetricsRegistry(rank=1), rank=1)
        w1.close()
        assert th.load_manifest(str(other)) is None

    def test_first_write_failure_kills_writer_not_run(self, tmp_path):
        reg = tm.MetricsRegistry(rank=0)
        w = _writer(th, tmp_path, reg)
        shutil.rmtree(tmp_path)
        reg.counter("t_c").inc()
        w.flush(wait=True)
        assert w._dead and w._m_err.value == 1
        assert "history_error" in [e["event"] for e in reg.events()]
        w.poke()
        w.flush(wait=True)
        assert w._m_err.value == 1
        w.close()

    def test_poke_respects_interval_deadline(self, tmp_path):
        reg = tm.MetricsRegistry(rank=0)
        w = _writer(th, tmp_path, reg, interval_s=1000.0)
        try:
            w.poke(now=0.0)
            w.flush(wait=True)
            n0 = len(th.read_records(str(tmp_path))[0])
            for now in (1.0, 2.0, 999.0):
                w.poke(now=now)
            assert not w._want
            w.poke(now=1001.0)
            w.flush(wait=True)
        finally:
            w.close()
        assert len(th.read_records(str(tmp_path))[0]) > n0

    def test_module_facade(self, tmp_path, monkeypatch):
        monkeypatch.setenv("HVD_HISTORY_DIR", str(tmp_path))
        try:
            assert not th.reset(enabled=False).enabled
            th.poke()
            assert list(tmp_path.glob("history-*.jsonl")) == []
            w = th.reset(enabled=True, dirpath=str(tmp_path),
                         interval_s=3600.0)
            th.flush(wait=True)
            records, torn = jh.read_records(str(tmp_path),
                                            rank=w.rank or 0)
            assert torn == 0 and records
        finally:
            th.reset(enabled=False)
