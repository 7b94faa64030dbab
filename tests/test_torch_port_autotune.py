"""The port's autotuner (``horovod_tpu_torch/utils/autotune.py`` over
``csrc/host/autotune.cc``) against the JAX package's, mirroring
``tests/test_autotune_sync.py``:

  * the native GP engine's ``suggest()`` sequence equals the JAX native
    engine's for the same seed and recorded scores, and the random-search
    engine's does too;
  * ``Autotuner.record_cycle``, ``freeze`` (and its boundary clamp) and
    the CSV log equal, fed the same cycles;
  * ``HOROVOD_AUTOTUNE=1`` runs on the port's eager core: rank 0 scores
    flushes and moves the knobs within the bounds, every result stays
    exact, and ``_sync_tuned_params`` adopts rank 0's row;
  * two gloo ranks (the port's ``run()``, negotiated) end on identical
    tuned values once rank 0 freezes the tuner.
"""

import numpy as np
import pytest
import torch

from horovod_tpu.common.config import HorovodConfig as JConfig
from horovod_tpu.utils import autotune as ja
from horovod_tpu_torch.common.config import HorovodConfig as TConfig
from horovod_tpu_torch.run.launch import run
from horovod_tpu_torch.utils import autotune as ta

RUN_TIMEOUT_S = 120.0


def test_bounds_and_constants_equal():
    assert ta.THRESHOLD_BOUNDS == ja.THRESHOLD_BOUNDS
    assert ta.CYCLE_BOUNDS_MS == ja.CYCLE_BOUNDS_MS
    assert ta.CYCLE_BOUNDARY_FRAC == ja.CYCLE_BOUNDARY_FRAC
    assert (ta.CYCLES_PER_SAMPLE, ta.SAMPLES_PER_STEP) == \
        (ja.CYCLES_PER_SAMPLE, ja.SAMPLES_PER_STEP)


@pytest.mark.parametrize("engine", ["_NativeEngine", "_PythonEngine"])
@pytest.mark.parametrize("seed", [0, 7])
def test_engine_suggestions_equal(engine, seed):
    t, j = getattr(ta, engine)(seed), getattr(ja, engine)(seed)
    rng = np.random.default_rng(seed)
    assert t.best() is None and j.best() is None
    for _ in range(12):
        st, sj = t.suggest(), j.suggest()
        assert st == sj
        score = float(rng.uniform(0.0, 10.0))
        t.record(st[0], st[1], score)
        j.record(sj[0], sj[1], score)
        assert t.best() == j.best()


def _cycles(seed=3, n=300):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(1, 1 << 24)), float(rng.uniform(1e-4, 5e-2)))
            for _ in range(n)]


@pytest.mark.parametrize("cycle_ms", [5.0, 99.5])
def test_autotuner_record_freeze_and_log_equal(tmp_path, cycle_ms):
    tlog, jlog = tmp_path / "port.csv", tmp_path / "jax.csv"
    t = ta.Autotuner(TConfig(cycle_time_ms=cycle_ms), log_path=str(tlog))
    j = ja.Autotuner(JConfig(cycle_time_ms=cycle_ms), log_path=str(jlog))
    assert type(t._engine).__name__ == type(j._engine).__name__ == \
        "_NativeEngine"
    for nbytes, dt in _cycles():
        assert t.record_cycle(nbytes, dt) == j.record_cycle(nbytes, dt)
        assert (t.threshold, t.cycle_time_ms) == \
            (j.threshold, j.cycle_time_ms)
    assert t.best() == j.best()
    assert t.freeze() == j.freeze()
    assert (t.threshold, t.cycle_time_ms, t.cycle_boundary_clamped) == \
        (j.threshold, j.cycle_time_ms, j.cycle_boundary_clamped)
    assert not t.record_cycle(1, 1.0)
    t.close()
    j.close()
    assert tlog.read_text() == jlog.read_text()
    rows = tlog.read_text().splitlines()
    assert rows[0] == "threshold_bytes,cycle_time_ms,score_bytes_per_us"
    assert len(rows) == 1 + 300 // (ta.CYCLES_PER_SAMPLE *
                                    ta.SAMPLES_PER_STEP)


def test_freeze_clamps_a_boundary_cycle():
    t = ta.Autotuner(TConfig(cycle_time_ms=5.0))
    t._engine.record(1e6, 99.9, 100.0)
    t._engine.record(2e6, 50.0, 1.0)
    best = t.freeze()
    assert best[1] == pytest.approx(99.9)
    assert t.cycle_boundary_clamped and t.cycle_time_ms == 5.0
    assert t.threshold == 1e6


def test_python_engine_when_the_native_core_is_off(monkeypatch):
    monkeypatch.setenv("HVD_DISABLE_NATIVE", "1")
    t = ta.Autotuner(TConfig())
    assert isinstance(t._engine, ta._PythonEngine)


def test_autotune_runs_on_the_eager_core(monkeypatch, tmp_path):
    """HOROVOD_AUTOTUNE=1 no longer raises: one CPU rank scores its
    flushes, moves the knobs within the bounds at each scored step, and
    every sum stays exact; freeze adopts the best point."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import state
    log = tmp_path / "tune.csv"
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG", str(log))
    monkeypatch.setenv("HOROVOD_CYCLE_TIME", "1")
    monkeypatch.setattr(ta, "CYCLES_PER_SAMPLE", 1)
    monkeypatch.setattr(ta, "SAMPLES_PER_STEP", 1)
    hvd.init(device="cpu")
    try:
        coord = state.global_state().coordinator
        cfg = state.global_state().config
        assert coord.autotuner is not None
        seen = set()
        for i in range(12):
            out = hvd.allreduce(torch.full((64,), float(i)), average=False,
                                name=f"t{i}")
            assert torch.equal(out, torch.full((64,), float(i)))
            seen.add((cfg.fusion_threshold, cfg.cycle_time_ms))
            assert ta.THRESHOLD_BOUNDS[0] <= cfg.fusion_threshold <= \
                ta.THRESHOLD_BOUNDS[1]
            assert ta.CYCLE_BOUNDS_MS[0] <= cfg.cycle_time_ms <= \
                ta.CYCLE_BOUNDS_MS[1]
        assert len(seen) > 1       # the knobs moved
        best = coord.freeze_autotune()
        assert best is not None and coord.autotuner.frozen
        assert cfg.fusion_threshold == int(best[0])
    finally:
        hvd.shutdown()
    rows = log.read_text().splitlines()
    assert rows[0] == "threshold_bytes,cycle_time_ms,score_bytes_per_us"
    assert len(rows) > 2
    for row in rows[1:]:
        thr, ct, score = (float(v) for v in row.split(","))
        assert ta.THRESHOLD_BOUNDS[0] <= thr <= ta.THRESHOLD_BOUNDS[1]
        assert ta.CYCLE_BOUNDS_MS[0] <= ct <= ta.CYCLE_BOUNDS_MS[1]
        assert score > 0


def test_sync_tuned_params_adopts_row_0(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import state
    hvd.init(device="cpu")
    try:
        coord = state.global_state().coordinator
        cfg = state.global_state().config
        coord._proposed_params = (123456.0, 7.5)
        coord._autotune_pending_adoption = True
        coord._sync_tuned_params()
        assert (cfg.fusion_threshold, cfg.cycle_time_ms) == (123456, 7.5)
        assert coord._proposed_params is None
        assert not coord._autotune_pending_adoption
    finally:
        hvd.shutdown()


def _sync_job():
    def fn():
        import time
        import torch
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.common import state
        from horovod_tpu_torch.utils import autotune as at
        at.CYCLES_PER_SAMPLE = 1
        at.SAMPLES_PER_STEP = 1
        hvd.init(device="cpu")
        coord = state.global_state().coordinator
        cfg = state.global_state().config
        vals = []
        for i in range(10):
            out = hvd.allreduce(torch.full((3,), float(i)), average=False,
                                name=f"v{i}")
            vals.append(float(out[0]))
        if hvd.rank() == 0:
            coord.freeze_autotune()
        # collectives ordered after the freeze carry the frozen values
        for i in range(3):
            hvd.allreduce(torch.ones(2), name=f"after{i}")
        time.sleep(0.2)
        out = {"rank": hvd.rank(), "vals": vals,
               "tuner": coord.autotuner is not None,
               "params": (int(cfg.fusion_threshold),
                          round(float(cfg.cycle_time_ms), 6))}
        hvd.shutdown()
        return out
    return fn


def test_two_ranks_adopt_identical_tuned_values():
    res = run(_sync_job(), num_proc=2,
              env={"HOROVOD_AUTOTUNE": "1", "HVD_FLIGHT_SIGTERM": "0"},
              start_timeout_s=RUN_TIMEOUT_S)
    assert [r["tuner"] for r in res] == [True, False]   # only rank 0
    want = [2.0 * i for i in range(10)]
    assert res[0]["vals"] == want and res[1]["vals"] == want
    assert res[0]["params"] == res[1]["params"]
    assert res[0]["params"] != (64 * 1024 * 1024, 5.0)
