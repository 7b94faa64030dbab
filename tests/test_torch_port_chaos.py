"""The port's chaos plane (``horovod_tpu_torch/run/chaos.py`` and its
injection points in ``run/network.py``), mirroring the
``tests/test_chaos_plane.py`` classes TestChaosSpec, TestClientBackoff,
TestInjectedTransportFaults, TestLostResponseInjected,
TestDrillDropResponses, TestDrillWorkerKilled and TestDrillPostmortem,
and the four tests of ``tests/test_negotiation_chaos.py`` on the port's
``run()``.

Parity is equality for the decision stream: one spec and seed give the
same ``ChaosRule.fire`` and ``ChaosInjector.decide`` sequence in both
packages. The drills hold invariants (every rank applies one order, a
killed rank is named within a deadline, the postmortem names the faulted
rank), since which message a fault hits depends on timing. The storm
and the silent-rank drill run 4 processes where the JAX tests run 8, to
keep the suite's time bounded; every multi-process drill has its own
deadline.
"""

import os
import signal
import subprocess
import sys
import time

import pytest

from horovod_tpu.run import chaos as jchaos
from horovod_tpu_torch.common.config import HorovodConfig
from horovod_tpu_torch.common.exceptions import RanksLostError
from horovod_tpu_torch.ops import negotiation as neg
from horovod_tpu_torch.run import chaos, network
from horovod_tpu_torch.run.launch import run
from horovod_tpu_torch.utils import metrics as tm

KEY = b"k" * 32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 120.0


def _config(**kw):
    kw.setdefault("fusion_threshold", 0)
    kw.setdefault("stall_warning_time_seconds", 0)
    return HorovodConfig(**kw)


def _addr_map(port):
    return {"local": [("127.0.0.1", port)]}


# module-level, so the wire pickles them by reference
class ApplyRequest:
    def __init__(self, req_id):
        self.req_id = req_id


class ApplyReply:
    def __init__(self, req_id):
        self.req_id = req_id


class CountingService(network.BasicService):
    """A service that does not dedupe: records every application."""

    NAME = "chaos.counting"

    def __init__(self, key):
        self.applied = []
        super().__init__(self.NAME, key)

    def _handle(self, req, client_address):
        if isinstance(req, ApplyRequest):
            self.applied.append(req.req_id)
            return ApplyReply(req.req_id)
        return super()._handle(req, client_address)


@pytest.mark.chaos
class TestDecisionParity:
    @pytest.mark.parametrize("spec,seed", [
        ("hvd.negotiation:*:drop_response:0.2", 1234),
        ("hvd.*:Resp:drop_response:0.3;hvd.negotiation:Req:dup_request:"
         "0.5:7", 7),
        ("*:Cycle*:delay_request:0.25;*:*:reset:0.1;"
         "*:*:truncate_response:0.05:3", 99),
    ])
    def test_same_decision_sequence_in_both_packages(self, spec, seed):
        msgs = [("request", "CycleRequest"), ("response", "CycleResponse"),
                ("request", "PingRequest"), ("response", "Resp"),
                ("request", "Req")]
        seqs = []
        for mod in (chaos, jchaos):
            rules = mod.parse_spec(spec, seed)
            assert [r.text for r in rules] == \
                [r.text for r in jchaos.parse_spec(spec, seed)]
            inj = mod.ChaosInjector("hvd.negotiation", rules, 0.0)
            seqs.append([inj.decide(*msgs[i % len(msgs)])
                         for i in range(600)])
            seqs.append(inj.stats())
        assert seqs[0] == seqs[2] and seqs[1] == seqs[3]
        assert any(seqs[0])

    def test_same_fire_stream_per_rule(self):
        for seed in (0, 7, 8, 2 ** 31 - 1):
            (a,) = chaos.parse_spec("s:Resp:drop_response:0.3:40", seed)
            (b,) = jchaos.parse_spec("s:Resp:drop_response:0.3:40", seed)
            assert [a.fire() for _ in range(300)] == \
                [b.fire() for _ in range(300)]
            assert a.injected == b.injected == 40


@pytest.mark.chaos
class TestChaosSpec:
    def test_malformed_rules_raise(self):
        for bad in ("svc:Msg:drop_request", "svc:Msg:no_such_fault:0.5",
                    "svc:Msg:drop_request:1.5", "svc:drop_request:0.5"):
            with pytest.raises(ValueError):
                chaos.parse_spec(bad, 0)

    def test_blank_spec_is_empty(self):
        assert chaos.parse_spec("", 0) == []
        assert chaos.parse_spec(" ; ;", 0) == []

    def test_injector_filters_by_service(self):
        rules = chaos.parse_spec("hvd.negotiation:*:drop_request:1.0", 0)
        assert not chaos.ChaosInjector("chaos.counting", rules, 50.0)
        inj = chaos.ChaosInjector("hvd.negotiation", rules, 50.0)
        assert inj.decide("request", "CycleRequest") == "drop_request"
        assert inj.decide("response", "CycleResponse") is None

    def test_from_env(self, monkeypatch):
        assert chaos.from_env("hvd.negotiation") is None
        monkeypatch.setenv("HVD_CHAOS_SPEC", "hvd.*:*:reset:0.5")
        monkeypatch.setenv("HOROVOD_CHAOS_SEED", "3")
        monkeypatch.setenv("HVD_CHAOS_DELAY_MS", "20")
        inj = chaos.from_env("hvd.negotiation")
        assert inj and inj.delay_s == pytest.approx(0.02)
        assert chaos.from_env("other") is None
        # the seed reached the rule: the JAX package's stream for seed 3
        (ref,) = jchaos.parse_spec("hvd.*:*:reset:0.5", 3)
        assert [inj.decide("response", "X") == "reset"
                for _ in range(50)] == [ref.fire() for _ in range(50)]

    def test_injection_is_counted(self):
        reg = tm.reset(enabled=True)
        try:
            inj = chaos.ChaosInjector(
                "svc", chaos.parse_spec("svc:*:drop_request:1.0", 0), 0)
            assert inj.decide("request", "X") == "drop_request"
            assert reg.counter("hvd_chaos_injections_total",
                               labels=("fault",)).labels(
                fault="drop_request").value == 1
        finally:
            tm.reset()


@pytest.mark.chaos
class TestClientBackoff:
    def test_full_jitter_bounded_by_cap_and_counted(self):
        svc = network.BasicService("chaos.backoff", KEY)
        try:
            c = network.BasicClient("chaos.backoff", _addr_map(svc.port),
                                    KEY)
            for attempt in range(12):
                bound = min(0.05 * 2 ** attempt, 1.0)
                assert all(0.0 <= c._backoff_delay(attempt) <= bound + 1e-9
                           for _ in range(8))
            assert all(c._backoff_delay(60) <= 1.0 for _ in range(20))
            c.close()
        finally:
            svc.shutdown()


@pytest.mark.chaos
class TestInjectedTransportFaults:
    def test_retry_resends_same_request_verbatim(self, monkeypatch):
        monkeypatch.setenv("HVD_CHAOS_SPEC",
                           "chaos.counting:ApplyReply:drop_response:1.0:1")
        reg = tm.reset(enabled=True)
        svc = CountingService(KEY)
        try:
            c = network.BasicClient(CountingService.NAME,
                                    _addr_map(svc.port), KEY,
                                    retry_requests=True,
                                    backoff_base_s=0.01)
            resp = c.request(ApplyRequest(7))
            assert isinstance(resp, ApplyReply) and resp.req_id == 7
            assert svc.applied == [7, 7]
            assert sum(svc._chaos.stats().values()) == 1
            # the transport counted its silent resend
            assert reg.counter("hvd_transport_retries_total").value == 1
            assert reg.counter(
                "hvd_transport_backoff_seconds_total").value <= 0.01
            c.close()
        finally:
            svc.shutdown()
            tm.reset()

    def test_no_retry_never_double_applies(self, monkeypatch):
        monkeypatch.setenv("HVD_CHAOS_SPEC",
                           "chaos.counting:ApplyReply:drop_response:1.0:1")
        svc = CountingService(KEY)
        try:
            c = network.BasicClient(CountingService.NAME,
                                    _addr_map(svc.port), KEY)
            with pytest.raises((OSError, EOFError)):
                c.request(ApplyRequest(9))
            assert svc.applied == [9]
            assert c.request(ApplyRequest(10)).req_id == 10
            assert svc.applied == [9, 10]
            c.close()
        finally:
            svc.shutdown()

    @pytest.mark.parametrize("fault,errors", [
        ("truncate_response", (EOFError,)),
        ("reset", (OSError, EOFError)),
        ("drop_request", (OSError, EOFError)),
    ])
    def test_severed_exchanges_read_as_disconnects(self, monkeypatch, fault,
                                                   errors):
        msg = "ApplyRequest" if fault == "drop_request" else "ApplyReply"
        monkeypatch.setenv("HVD_CHAOS_SPEC",
                           f"chaos.counting:{msg}:{fault}:1.0:1")
        svc = CountingService(KEY)
        try:
            c = network.BasicClient(CountingService.NAME,
                                    _addr_map(svc.port), KEY)
            # a mid-frame cut is a disconnect, never an HMAC failure
            with pytest.raises(errors):
                c.request(ApplyRequest(1))
            assert svc.applied == ([] if fault == "drop_request" else [1])
            c.close()
        finally:
            svc.shutdown()

    def test_delay_response_is_bounded_by_knob(self, monkeypatch):
        monkeypatch.setenv("HVD_CHAOS_SPEC",
                           "chaos.counting:ApplyReply:delay_response:1.0:1")
        monkeypatch.setenv("HVD_CHAOS_DELAY_MS", "200")
        svc = CountingService(KEY)
        try:
            c = network.BasicClient(CountingService.NAME,
                                    _addr_map(svc.port), KEY)
            t0 = time.monotonic()
            assert c.request(ApplyRequest(3)).req_id == 3
            assert time.monotonic() - t0 >= 0.15
            c.close()
        finally:
            svc.shutdown()

    def test_dup_request_deduped_by_coordinator_req_id(self, monkeypatch):
        monkeypatch.setenv("HVD_CHAOS_SPEC",
                           "hvd.negotiation:CycleRequest:dup_request:1.0:1")
        svc = neg.CoordinatorService(1, KEY, ports=[0], config=_config())
        try:
            c = network.BasicClient(neg.SERVICE_NAME, _addr_map(svc.port),
                                    KEY)
            m = neg.EntryMeta("a", "allreduce", "float32", (4,), 0, False)
            resp = c.request(neg.CycleRequest(0, [m], -1, req_id=1))
            assert sum(svc._chaos.stats().values()) == 1
            assert svc._base_seq + len(svc._responses) == 1
            (r,) = resp.responses
            assert r.kind == r.EXECUTE and r.names == ["a"]
            c.close()
        finally:
            svc.shutdown()


@pytest.mark.chaos
class TestLostResponseInjected:
    def test_dropped_unknown_ids_survive_transport_retry(self, monkeypatch):
        monkeypatch.setenv(
            "HVD_CHAOS_SPEC",
            "hvd.negotiation:CycleResponse:drop_response:1.0:1")
        svc = neg.CoordinatorService(2, KEY, ports=[0], config=_config())
        try:
            c = network.BasicClient(neg.SERVICE_NAME, _addr_map(svc.port),
                                    KEY, retry_requests=True,
                                    backoff_base_s=0.01)
            resp = c.request(neg.CycleRequest(
                0, [], -1, req_id=1, hits=neg.encode_hits([5])))
            assert sum(svc._chaos.stats().values()) == 1
            assert resp.unknown_ids == (5,)
            assert svc._seen_req[0] == (1, (5,))
            c.close()
        finally:
            svc.shutdown()


def _drop_responses_job():
    def fn():
        import os
        import time
        from horovod_tpu_torch.common.config import HorovodConfig
        from horovod_tpu_torch.ops import negotiation as neg
        rank = int(os.environ["HVD_PROCESS_ID"])
        nproc = 3
        addresses = [("127.0.0.1", int(p)) for p in
                     os.environ["HVD_CHAOS_DRILL_PORTS"].split(",")]
        cfg = HorovodConfig(fusion_threshold=0,
                            stall_warning_time_seconds=0)
        worker = neg.NegotiationWorker(rank, nproc, cfg, addresses,
                                       neg.control_key(),
                                       start_timeout_s=60.0)
        names = [f"g{i}" for i in range(10)]
        entries = [neg.EntryMeta(n, "allreduce", "float32", (4,), 0, False)
                   for n in names]
        applied, ack, req_id = [], -1, 1
        deadline = time.monotonic() + 60.0
        while len(applied) < len(names):
            if time.monotonic() > deadline:
                raise RuntimeError(f"rank {rank}: deadline with {applied}")
            try:
                resp = worker.cycle(entries, ack, req_id=req_id)
            except (OSError, EOFError):
                time.sleep(0.05)  # resend the SAME req_id
                continue
            entries = []
            req_id += 1
            for i, r in enumerate(resp.responses):
                seq = resp.base_seq + i
                if seq <= ack:
                    continue
                assert seq == ack + 1, "gap in the response log"
                assert r.kind == r.EXECUTE, r.error
                applied.extend(r.names)
                ack = seq
            time.sleep(0.005)
        for _ in range(5):
            try:
                worker.cycle([], ack, req_id=req_id)
                break
            except (OSError, EOFError):
                time.sleep(0.05)
        stats = None
        if rank == 0:
            svc = worker.service
            deadline = time.monotonic() + 60.0
            while not (len(svc._acks) == nproc and
                       min(svc._acks.values()) >= len(names) - 1):
                if time.monotonic() > deadline:
                    raise RuntimeError(f"acks never converged: {svc._acks}")
                time.sleep(0.02)
            stats = svc._chaos.stats()
        worker.close(linger_s=0.5)
        return applied, stats
    return fn


@pytest.mark.chaos
class TestDrillDropResponses:
    def test_negotiation_completes_under_20pct_response_loss(self):
        ports = set()
        while len(ports) < 3:
            ports.add(network.free_port())
        env = {"HVD_CHAOS_DRILL_PORTS": ",".join(map(str, sorted(ports))),
               "HVD_CHAOS_SPEC":
                   "hvd.negotiation:CycleResponse:drop_response:0.2",
               "HVD_CHAOS_SEED": "1234"}
        t0 = time.monotonic()
        results = run(_drop_responses_job(), num_proc=3, env=env,
                      start_timeout_s=RUN_TIMEOUT_S)
        assert time.monotonic() - t0 < 90.0
        orders = [applied for applied, _ in results]
        assert sorted(orders[0]) == [f"g{i}" for i in range(10)]
        assert orders[1] == orders[0] and orders[2] == orders[0]
        stats = results[0][1]
        assert stats is not None and sum(stats.values()) > 0, stats


_VICTIM_SCRIPT = r"""
import sys, time
from horovod_tpu_torch.common.config import HorovodConfig
from horovod_tpu_torch.ops import negotiation as neg

port = int(sys.argv[1])
cfg = HorovodConfig(fusion_threshold=0, stall_warning_time_seconds=0)
w = neg.NegotiationWorker(1, 3, cfg, [("127.0.0.1", port)], b"k" * 32,
                          start_timeout_s=30.0)
req_id = 1
while True:  # heartbeat until SIGKILLed
    try:
        w.cycle([], -1, req_id=req_id)
        req_id += 1
    except Exception:
        pass
    time.sleep(0.1)
"""


@pytest.mark.chaos
class TestDrillWorkerKilled:
    def test_killed_rank_fails_fast_with_ranks_lost(self):
        reg = tm.reset(enabled=True)
        cfg = _config(rank_lost_timeout_seconds=1.5)
        svc = neg.CoordinatorService(3, KEY, ports=[0], config=cfg)
        victim = worker2 = None
        try:
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                [ROOT] + env.get("PYTHONPATH", "").split(os.pathsep))
            victim = subprocess.Popen(
                [sys.executable, "-c", _VICTIM_SCRIPT, str(svc.port)],
                env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
            deadline = time.monotonic() + 60.0
            while 1 not in svc._last_seen:
                assert time.monotonic() < deadline, "victim never cycled"
                assert victim.poll() is None, victim.poll()
                time.sleep(0.05)
            worker2 = neg.NegotiationWorker(2, 3, cfg,
                                            [("127.0.0.1", svc.port)],
                                            KEY, start_timeout_s=30.0)
            m = neg.EntryMeta("w", "allreduce", "float32", (4,), 0, False)
            svc._handle(neg.CycleRequest(0, [m], -1, req_id=1), ("", 0))
            assert worker2.cycle([m], -1, req_id=1).lost_ranks == ()
            victim.send_signal(signal.SIGKILL)
            victim.wait(timeout=10.0)
            t0 = time.monotonic()
            err, req_id = None, 2
            while time.monotonic() - t0 < 15.0:
                svc._handle(neg.CycleRequest(0, [], -1, req_id=req_id),
                            ("", 0))
                try:
                    neg.raise_if_ranks_lost(
                        worker2.cycle([], -1, req_id=req_id))
                except RanksLostError as e:
                    err = e
                    break
                req_id += 1
                time.sleep(0.1)
            assert err is not None, "survivors never saw RanksLostError"
            assert time.monotonic() - t0 < 10.0
            assert err.ranks == (1,)
            errors = [r for r in svc._responses if r.kind == r.ERROR]
            assert any("RanksLostError" in r.error and r.names == ["w"]
                       for r in errors), errors
            # the ledger's verdict is telemetry too
            assert reg.gauge("hvd_lost_ranks").value == 1
            (ev,) = [e for e in reg.events() if e["event"] == "ranks_lost"]
            assert ev["ranks"] == [1]
        finally:
            if victim is not None and victim.poll() is None:
                victim.kill()
                victim.wait(timeout=10.0)
            if worker2 is not None:
                worker2.close(linger_s=0.0)
            svc.shutdown()
            tm.reset()


def _postmortem_job():
    def fn():
        import os
        import torch
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.common.exceptions import RanksLostError
        hvd.init(device="cpu")
        r = int(os.environ["HVD_PROCESS_ID"])
        h = hvd.allreduce_async(torch.ones(8), average=False,
                                name="grad_drill")
        err = None
        try:
            hvd.synchronize(h)
        except RanksLostError as e:
            err = str(e)
        finally:
            try:
                hvd.shutdown()
            except Exception:  # noqa: BLE001 — a failed job's teardown
                pass
        return r, err
    return fn


@pytest.mark.chaos
class TestDrillPostmortem:
    def test_flight_dumps_and_postmortem_name_the_faulted_rank(
            self, tmp_path):
        # no SIGTERM dump: run()'s launcher SIGTERMs workers still
        # exiting after they reported
        env = {"HVD_FLIGHT_DIR": str(tmp_path), "HVD_FLIGHT_SIGTERM": "0",
               "HVD_CHAOS_SPEC":
                   "hvd.negotiation:CycleResponse:drop_response:1.0",
               "HVD_CHAOS_SEED": "7",
               "HVD_COORDINATOR_LOST_TIMEOUT_SECONDS": "2.0"}
        by_rank = dict(run(_postmortem_job(), num_proc=3, env=env,
                           start_timeout_s=RUN_TIMEOUT_S))
        assert sorted(by_rank) == [0, 1, 2]
        for r, err in by_rank.items():
            assert err is not None, f"rank {r} never saw RanksLostError"
            assert "0" in err
        assert any("[trace " in err for err in by_rank.values()), by_rank
        dumps = sorted(p.name for p in tmp_path.glob("flight-rank*.json"))
        assert dumps == [f"flight-rank{r}.json" for r in range(3)], dumps
        sys.path.insert(0, os.path.join(ROOT, "tools"))
        import hvd_postmortem
        loaded, bad = hvd_postmortem.load_dumps(
            hvd_postmortem.find_dumps(str(tmp_path)))
        assert not bad and len(loaded) == 3
        hvd_postmortem.rebase(loaded)
        verdict = hvd_postmortem.analyze(loaded)
        assert verdict["divergent_rank"] == 0, verdict
        assert verdict["tensor"] == "grad_drill", verdict
        assert verdict["trace_id"], verdict
        assert verdict["chaos_injections"], verdict
        assert "grad_drill" in verdict["waiting"]
        report = hvd_postmortem.render_report(
            loaded, [], verdict, hvd_postmortem.last_cycles(loaded, 8), 0)
        assert "divergent rank : 0" in report


def _storm_job():
    def fn():
        import os
        import random
        import time
        import torch
        import horovod_tpu_torch as hvd
        hvd.init(device="cpu")
        r = int(os.environ["HVD_PROCESS_ID"])
        rng = random.Random(1234 + r)
        out = {}
        for burst in range(2):
            names = [f"s{burst}.t{i}" for i in range(6)]
            order = list(names)
            rng.shuffle(order)
            handles = {}
            for n in order:
                i = int(n.split("t")[1])
                handles[n] = hvd.allreduce_async(
                    torch.full((4,), float((r + 1) * (i + 1))),
                    average=False, name=n)
                time.sleep(rng.uniform(0, 0.02))
            for n, h in handles.items():
                out[n] = float(hvd.synchronize(h)[0])
        hvd.shutdown()
        return out
    return fn


def _silent_job():
    def fn():
        import os
        import time
        import torch
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.common import state
        hvd.init(device="cpu")
        r = int(os.environ["HVD_PROCESS_ID"])
        common = float(hvd.allreduce(torch.ones(2), average=False,
                                     name="pre.common")[0])
        cfg = state.global_state().config
        cfg.stall_warning_time_seconds = 0.5
        cfg.stall_shutdown_time_seconds = 2.0
        if r == 3:
            state.global_state().coordinator._paused = True
            time.sleep(4.0)  # past the peers' deadline
            hvd.shutdown()
            return "silent", common
        try:
            hvd.allreduce(torch.ones(2), name="post")
            result = "completed"
        except hvd.StalledError:
            result = "stalled"
        except hvd.ShutdownError:
            result = "shutdown"
        hvd.shutdown()
        return result, common
    return fn


def _crash_job():
    def fn():
        import os
        import time
        import torch
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.common import state
        from horovod_tpu_torch.ops import eager
        eager.EagerCoordinator.POISON_GRACE_S = 1.0
        hvd.init(device="cpu")
        r = int(os.environ["HVD_PROCESS_ID"])
        common = float(hvd.allreduce(torch.ones(2), average=False,
                                     name="pre.crash")[0])
        coord = state.global_state().coordinator
        if r == 0:
            coord._negotiator.service.shutdown()  # no goodbye
            time.sleep(4.0)
            return "crashed", common
        result = "hung"
        try:
            hvd.allreduce(torch.ones(2), name="post.crash")
            result = "completed"
        except hvd.ShutdownError as e:
            result = ("unreachable" if "unreachable" in str(e)
                      else "shutdown")
        except hvd.StalledError:
            result = "stalled"
        return result, common
    return fn


def _overflow_job():
    def fn():
        import os
        import time
        import torch
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.common import state
        from horovod_tpu_torch.ops import negotiation as neg
        neg.CoordinatorService.MAX_RESPONSE_LOG = 4
        hvd.init(device="cpu")
        coord = state.global_state().coordinator
        if int(os.environ["HVD_PROCESS_ID"]) != 0:
            with coord.hold_cycle():
                handles = [hvd.allreduce_async(
                    torch.full((2,), 1.0), average=False, name=f"of.{i}")
                    for i in range(16)]
            time.sleep(1.0)
        else:
            time.sleep(0.8)  # the peers announce first
            with coord.hold_cycle():
                handles = [hvd.allreduce_async(
                    torch.full((2,), 1.0), average=False, name=f"of.{i}")
                    for i in range(16)]
        outcomes = set()
        for h in handles:
            try:
                hvd.synchronize(h)
                outcomes.add("ok")
            except hvd.ShutdownError as e:
                outcomes.add("overflow" if "overflow" in str(e)
                             else "shutdown")
            except hvd.StalledError:
                outcomes.add("stalled")
        hvd.shutdown()
        return sorted(outcomes)
    return fn


@pytest.mark.chaos
class TestNegotiationChaos:
    """``tests/test_negotiation_chaos.py`` on the port's ``run()``."""

    def test_storm_random_order_and_tempo(self):
        results = run(_storm_job(), num_proc=4,
                      start_timeout_s=RUN_TIMEOUT_S)
        world = sum(range(1, 5))
        for res in results:
            for burst in range(2):
                for i in range(6):
                    assert res[f"s{burst}.t{i}"] == world * (i + 1), res

    def test_rank_goes_silent_mid_cycle(self):
        results = run(_silent_job(), num_proc=4,
                      start_timeout_s=RUN_TIMEOUT_S)
        for r, (result, common) in enumerate(results):
            assert common == 4.0, results
            if r == 3:
                assert result == "silent"
            else:
                assert result in ("stalled", "shutdown"), (r, result)

    def test_coordinator_dies_abruptly(self):
        results = run(_crash_job(), num_proc=3,
                      start_timeout_s=RUN_TIMEOUT_S)
        for r, (result, common) in enumerate(results):
            assert common == 3.0, results
            if r == 0:
                assert result == "crashed"
            else:
                assert result in ("unreachable", "shutdown"), (r, result)
        assert any(res == "unreachable" for res, _ in results[1:]), results

    def test_response_log_overflow_fails_cleanly(self):
        results = run(_overflow_job(), num_proc=3,
                      env={"HOROVOD_FUSION_THRESHOLD": "0"},
                      start_timeout_s=RUN_TIMEOUT_S)
        assert any("overflow" in res for res in results), results
        for res in results:
            assert "ok" not in res or "overflow" not in res, results
