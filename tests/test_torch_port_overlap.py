"""The overlap plane (``EagerCoordinator.flush_ready``,
``optim.reduce_on_core`` under ``HOROVOD_OVERLAP_EAGER``) and the eager
core's two-level engine under ``HOROVOD_OVERLAP_HIERARCHICAL``, mirroring
``tests/test_overlap.py`` (all but
``TestHierarchicalEngine::test_trivial_world_quantized_matches_flat_math``,
which fails on the reference: ``ROADMAP.md`` §C).

One-process cases run the port and the JAX package (on a one-device
worker mesh, where a tensor reduces to itself as on one port rank) on
the same seeded inputs: the port's tally must count what the JAX
registry counts, and the results must be equal. Two-process cases run
through the port's ``run(fn)`` (two CPU processes over gloo, negotiated
by the job's secret): overlap on and off give the same fp32 bits on
every rank, the two-level engine carries int8 on the inter-host leg
only, and collectives under overlap and the two-level engine complete
with exact sums under a chaos delay on the control plane (the JAX
case's spec names the service "negotiation", which no service is
called, so it delays nothing; the port's names "hvd.negotiation").
"""

import time

import numpy as np
import pytest
import torch

from horovod_tpu_torch import optim as toptim
from horovod_tpu_torch.common import state as tstate
from horovod_tpu_torch.ops import eager as teager
from horovod_tpu_torch.ops import quantization as tq
from horovod_tpu_torch.run.launch import run

RUN_TIMEOUT_S = 120.0


@pytest.fixture
def jax1():
    """The JAX package on one device with a fresh enabled registry."""
    import jax
    import horovod_tpu as jhvd
    from horovod_tpu.utils import metrics as jmetrics
    reg = jmetrics.reset(enabled=True)
    jhvd.init(devices=jax.devices()[:1])
    yield jhvd, reg
    jhvd.shutdown()
    jmetrics.reset()


@pytest.fixture
def port1():
    import horovod_tpu_torch as thvd
    thvd.init(device="cpu")
    teager.reset_tally()
    tq.reset_tally()
    yield thvd
    thvd.shutdown()


def _coords(jhvd):
    import horovod_tpu
    return (horovod_tpu.common.state.global_state().coordinator,
            tstate.global_state().coordinator)


def _quiet(coord):
    """Park the background flush loop on a long wait, so the test's own
    flush_ready calls are the only dispatcher."""
    coord._config.cycle_time_ms = 5000.0
    time.sleep(0.05)


def _counts(reg):
    """(port tally, JAX registry) of the overlap counters."""
    names = ("hvd_overlap_ready_flushes_total",
             "hvd_overlap_ready_tensors_total", "hvd_overlap_wakes_total")
    t = teager.tally()
    return ({n: t.get((n,), 0) for n in names},
            {n: reg.counter(n).value for n in names})


class TestReadinessDispatch:
    def test_flush_ready_noop_when_disabled(self, jax1, port1):
        jhvd, reg = jax1
        jc, tc = _coords(jhvd)
        for c in (jc, tc):
            _quiet(c)
        x = np.ones((8, 64), np.float32)
        hj = jhvd.allreduce_async(x, average=False, name="off.t0")
        ht = port1.allreduce_async(torch.from_numpy(x), average=False,
                                   name="off.t0")
        jc.flush_ready()
        tc.flush_ready()
        got, want = _counts(reg)
        assert got == want and got["hvd_overlap_ready_flushes_total"] == 0
        np.testing.assert_array_equal(port1.synchronize(ht).numpy(),
                                      np.asarray(jhvd.synchronize(hj)))

    def test_flush_ready_drains_sealed_group_keeps_partial(self, jax1,
                                                           port1):
        jhvd, reg = jax1
        outs = {}
        for pkg, coord, wrap in ((jhvd, _coords(jhvd)[0], np.asarray),
                                 (port1, _coords(jhvd)[1],
                                  torch.from_numpy)):
            cfg = coord._config
            cfg.overlap_eager = True
            cfg.fusion_threshold = 2048
            _quiet(coord)
            # another average flag is another fusion group, so "partial"
            # is a group of its own, not a member of the sealed one
            h_small = pkg.allreduce_async(wrap(np.ones((8, 4), np.float32)),
                                          average=True, name="seal.small")
            coord.flush_ready()
            big = np.arange(8.0 * 64, dtype=np.float32).reshape(8, 64)
            first = _counts(reg)
            h_big = pkg.allreduce_async(wrap(big), average=False,
                                        name="seal.big")
            coord.flush_ready()
            outs[pkg] = (first, np.asarray(pkg.synchronize(h_big)),
                         np.asarray(pkg.synchronize(h_small)))
        (t_first, t_big, t_small), (j_first, j_big, j_small) = \
            outs[port1], outs[jhvd]
        got, want = _counts(reg)
        assert got == want
        assert got["hvd_overlap_ready_flushes_total"] == 1
        assert got["hvd_overlap_ready_tensors_total"] == 1
        assert t_first[0]["hvd_overlap_ready_flushes_total"] == 0
        np.testing.assert_array_equal(t_big, j_big)
        np.testing.assert_array_equal(t_small, j_small)

    def test_reverse_order_enqueue_dispatches_before_final_drain(
            self, jax1, port1):
        from horovod_tpu import optim as joptim
        jhvd, reg = jax1
        rng = np.random.RandomState(7)
        grads = {f"layer{i}": rng.randn(8, 64).astype(np.float32)
                 for i in range(4)}  # 2048 B each: every leaf seals
        for coord in _coords(jhvd):
            coord._config.overlap_eager = True
            coord._config.fusion_threshold = 2048
            _quiet(coord)
        want = joptim.allreduce_gradients(grads, average=False)
        got = toptim.allreduce_gradients(
            {k: torch.from_numpy(v) for k, v in grads.items()},
            average=False)
        t, j = _counts(reg)
        assert t == j and t["hvd_overlap_ready_flushes_total"] >= 1
        assert t["hvd_overlap_ready_tensors_total"] >= 1
        for k in grads:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        windows = teager.tally()
        assert windows[("hvd_grad_reduce_steps_total", "overlap")] == 1
        assert windows[("hvd_grad_enqueue_ms_total", "overlap")] > 0


class TestBitForBitParity:
    def _grads(self, seed):
        rng = np.random.RandomState(seed)
        return {f"l{i}": rng.randn(8, 48 + 16 * i).astype(np.float32)
                for i in range(5)}

    def test_fp32_overlap_matches_barrier_bitwise(self, jax1, port1):
        from horovod_tpu import optim as joptim
        jhvd, _ = jax1
        grads = self._grads(11)
        tgrads = {k: torch.from_numpy(v) for k, v in grads.items()}
        res = {}
        for mode in (False, True):
            for coord in _coords(jhvd):
                coord._config.fusion_threshold = 4096
                coord._config.overlap_eager = mode
                if mode:
                    _quiet(coord)
            res[mode] = (
                {k: v.numpy() for k, v in toptim.allreduce_gradients(
                    tgrads, average=True).items()},
                {k: np.asarray(v) for k, v in joptim.allreduce_gradients(
                    grads, average=True).items()})
        for k in grads:
            barrier, overlap = res[False][0][k], res[True][0][k]
            assert barrier.dtype == overlap.dtype == np.float32
            assert np.array_equal(barrier, overlap), k
            assert np.array_equal(overlap, res[True][1][k]), k
        modes = {key[1] for key in teager.tally()
                 if key[0] == "hvd_grad_reduce_steps_total"}
        assert modes == {"barrier", "overlap"}

    def test_fp32_parity_two_process(self, two_process):
        """tests/test_overlap.py::…::test_fp32_parity_two_process: each
        rank reduces the same tensors with overlap off, then on."""
        for res in two_process["flat"]:
            assert res["negotiated"]
            assert all(res["equal"].values()), res
            assert res["wakes"] > 0, res


def _flat_job():
    def fn():
        import numpy as np
        import torch
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import optim
        from horovod_tpu_torch.common import state
        from horovod_tpu_torch.ops import eager
        hvd.init(device="cpu")
        cfg = state.global_state().config
        cfg.fusion_threshold = 4096
        rng = np.random.RandomState(3 + hvd.rank())
        grads = {f"l{i}": torch.from_numpy(
            rng.randn(32 + 16 * i).astype(np.float32)) for i in range(4)}
        big = {f"b{i}": torch.from_numpy(
            rng.randn(1024).astype(np.float32)) for i in range(4)}
        grads.update(big)
        cfg.overlap_eager = False
        a = optim.allreduce_gradients(grads, average=True)
        cfg.overlap_eager = True
        b = optim.allreduce_gradients(grads, average=True)
        out = {"equal": {k: bool(torch.equal(a[k], b[k])) for k in grads},
               "negotiated": state.global_state().coordinator.negotiated,
               "wakes": eager.tally().get(("hvd_overlap_wakes_total",), 0)}
        hvd.shutdown()
        return out
    return fn


def _hier_job():
    def fn():
        import torch
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.common import state
        from horovod_tpu_torch.ops import quantization as q
        hvd.init(device="cpu")
        coord = state.global_state().coordinator
        r = hvd.rank()
        out = hvd.allreduce(torch.full((512,), float(r + 1)),
                            average=False, name="hier.t0")
        eng = coord._hier_engine
        legs = {f"{k[1]}/{k[2]}": v for k, v in q.tally().items()
                if k[0] == "hvd_wire_leg_bytes_total"}
        hvd.shutdown()
        return {"ok": bool(torch.allclose(out, torch.full((512,), 3.0))),
                "hier": type(eng).__name__, "legs": legs}
    return fn


def _late_job():
    def fn():
        import torch
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.common import state
        hvd.init(device="cpu")
        r = hvd.rank()
        sums = [float(hvd.allreduce(
            torch.full((64,), float((r + 1) * (i + 1))), average=False,
            name=f"late.t{i}")[0]) for i in range(3)]
        eng = state.global_state().coordinator._hier_engine
        hvd.shutdown()
        return {"sums": sums, "hier": type(eng).__name__}
    return fn


@pytest.fixture(scope="module")
def two_process():
    hier_env = {"HOROVOD_COMPRESSION": "int8",
                "HOROVOD_QUANT_MIN_BYTES": "0",
                "HOROVOD_OVERLAP_HIERARCHICAL": "1",
                "HOROVOD_OVERLAP_LOCAL_SIZE": "1"}
    return {"flat": run(_flat_job(), num_proc=2,
                        start_timeout_s=RUN_TIMEOUT_S),
            "hier": run(_hier_job(), num_proc=2, env=hier_env,
                        start_timeout_s=RUN_TIMEOUT_S),
            "late": run(_late_job(), num_proc=2,
                        env={"HOROVOD_OVERLAP_EAGER": "1",
                             "HOROVOD_OVERLAP_HIERARCHICAL": "1",
                             "HOROVOD_OVERLAP_LOCAL_SIZE": "1",
                             "HVD_CHAOS_SPEC":
                                 "hvd.negotiation:*:delay_response:0.5",
                             "HVD_CHAOS_DELAY_MS": "120",
                             "HVD_CHAOS_SEED": "17"},
                        start_timeout_s=RUN_TIMEOUT_S)}


class TestHierarchicalEngine:
    def test_invalid_local_size_raises(self, jax1, port1):
        from horovod_tpu.ops.process_collectives import (
            HierarchicalProcessEngine as JEngine)
        from horovod_tpu_torch.ops.process_collectives import (
            HierarchicalProcessEngine as TEngine)
        with pytest.raises(ValueError, match="divide"):
            JEngine(3)  # 1 % 3 != 0
        with pytest.raises(ValueError, match="divide"):
            TEngine(_coords(jax1[0])[1].group, 3)

    def test_hier_engine_ineligible_single_process(self, jax1, port1):
        for coord in _coords(jax1[0]):
            coord._config.overlap_hierarchical = True
            coord._config.overlap_local_size = 1
            assert coord._hier_engine is None

    def test_fingerprint_suffix_only_when_hierarchical(self, jax1, port1):
        from horovod_tpu.ops import quantization as jq
        cfg = tstate.global_state().config
        base = tq.config_fingerprint(cfg)
        assert "/h" not in base and base == jq.config_fingerprint(cfg)
        cfg.overlap_hierarchical = True
        cfg.overlap_local_size = 4
        try:
            assert tq.config_fingerprint(cfg) == base + "/h4"
            assert tq.config_fingerprint(cfg) == jq.config_fingerprint(cfg)
        finally:
            cfg.overlap_hierarchical = False
            cfg.overlap_local_size = 0

    def test_overlap_knobs_parse_as_the_reference(self, monkeypatch):
        from horovod_tpu.common.config import HorovodConfig as JConfig
        from horovod_tpu_torch.common.config import HorovodConfig as TConfig
        monkeypatch.setenv("HOROVOD_OVERLAP_EAGER", "1")
        monkeypatch.setenv("HOROVOD_OVERLAP_HIERARCHICAL", "1")
        monkeypatch.setenv("HOROVOD_OVERLAP_LOCAL_SIZE", "2")
        t, j = TConfig.from_env(), JConfig.from_env()
        for f in ("overlap_eager", "overlap_hierarchical",
                  "overlap_local_size"):
            assert getattr(t, f) == getattr(j, f)
        assert (t.overlap_eager, t.overlap_local_size) == (True, 2)

    def test_account_leg_counters(self, jax1):
        from horovod_tpu.ops import quantization as jq
        _, reg = jax1
        tq.reset_tally()
        for q in (tq, jq):
            q.account_leg("intra", None, 4096)
            q.account_leg("inter", "int8", 1040)
        fam = reg.counter("hvd_wire_leg_bytes_total",
                          labels=("leg", "codec"))
        t = tq.tally()
        assert t[("hvd_wire_leg_bytes_total", "intra", "none")] == \
            fam.labels(leg="intra", codec="none").value == 4096
        assert t[("hvd_wire_leg_bytes_total", "inter", "int8")] == \
            fam.labels(leg="inter", codec="int8").value == 1040

    def test_error_feedback_peek(self):
        import jax.numpy as jnp
        from horovod_tpu.ops import quantization as jq
        rng = np.random.RandomState(0)
        comp = rng.randn(256).astype(np.float32)
        peeks = []
        for q, arr in ((tq, torch.from_numpy(comp)), (jq, jnp.asarray(comp))):
            ef = q.ErrorFeedback()
            assert ef.peek("k") is None
            pl, sc = q.encode(arr, 256, "int8")
            ef.update("k", arr, q.decode(pl, sc, 256, 256), 256)
            assert tuple(ef.peek("k").shape) == (256,)
            assert ef.peek("k", shape=(256,)) is not None
            assert ef.peek("k", shape=(512,)) is None
            peeks.append(np.asarray(ef.peek("k")))
        np.testing.assert_allclose(peeks[0], peeks[1], rtol=0, atol=1e-6)

    def test_two_process_hierarchical_int8_inter_leg_only(self,
                                                          two_process):
        """2 processes, local_size 1 (every process its own host): the
        fused eager allreduce rides the two-level engine, int8 crosses
        only the inter-host leg, and the sums of values int8 blocks hold
        exactly are exact."""
        for res in two_process["hier"]:
            assert res["ok"] and res["hier"] == "HierarchicalProcessEngine"
            assert res["legs"].get("inter/int8", 0) > 0, res
            assert "intra/int8" not in res["legs"], res


class TestDelayedInterHostLeg:
    def test_overlap_and_hierarchy_complete_exactly(self, two_process):
        """tests/test_overlap.py::TestChaosDelayedInterHostLeg: overlap
        plus the two-level engine on the negotiated control plane, half
        its responses delayed 120 ms, every collective complete with
        exact sums."""
        for res in two_process["late"]:
            assert res["hier"] == "HierarchicalProcessEngine", res
            assert res["sums"] == [3.0 * (i + 1) for i in range(3)], res
