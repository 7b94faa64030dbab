"""horovod_tpu_torch's serving plane: engine parity with the JAX engine,
the engine's scheduling cases, and the host-side pieces (scheduler,
block ledger, admission queue, sampling).

Slice-level parity: the port's ``ServeEngine`` on the CPU, holding the
JAX engine's tiny fp32 checkpoint (``params_from_flax``), must produce
the same temperature-0 tokens as ``horovod_tpu.serving.engine`` on the
same prompts. The engine cases mirror tests/test_serving.py without its
metrics asserts (the port's metrics plane comes later).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.serving.engine import ServeEngine
from horovod_tpu_torch.serving.kv_cache import BlockLedger, KVCache
from horovod_tpu_torch.serving.queue import AdmissionQueue, Request
from horovod_tpu_torch.serving.sampling import sample_tokens
from horovod_tpu_torch.serving.scheduler import SlotScheduler


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


PROMPTS = [(5, 9, 17), (4, 8, 15, 16, 23, 42)]


def _tiny(impl="full"):
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32,
                                     attention_impl=impl)
    return cfg, ttr.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")


def _engine(cfg, model, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("kv_block", 8)
    kw.setdefault("queue", AdmissionQueue(max_depth=64,
                                          admission_timeout_s=1e9))
    return ServeEngine(cfg, model, device="cpu", **kw)


def _greedy_reference(model, prompt, n_new):
    """No-cache greedy decode: a full forward over the growing sequence
    every step — the oracle the KV-cached engine must match."""
    toks = list(prompt)
    out = []
    for _ in range(n_new):
        logits = model(torch.tensor([toks]))
        nxt = int(torch.argmax(logits[0, -1]))
        out.append(nxt)
        toks.append(nxt)
    return out


# ---------------------------------------------------------------------------
# parity with the JAX engine
# ---------------------------------------------------------------------------

class TestJaxParity:
    @pytest.mark.parametrize("impl", ["full", "flash"])
    def test_temp0_tokens_equal_jax_engine(self, impl):
        from horovod_tpu.models import transformer as jtr
        from horovod_tpu.serving import queue as jqueue
        from horovod_tpu.serving.engine import ServeEngine as JaxEngine
        jcfg = jtr.TransformerConfig.tiny(dtype=jnp.float32,
                                          attention_impl="full")
        _, params = jtr.init_params(jcfg, jax.random.PRNGKey(0))
        jengine = JaxEngine(jcfg, params, num_slots=2, max_len=48,
                            kv_block=8,
                            queue=jqueue.AdmissionQueue(
                                max_depth=64, admission_timeout_s=1e9))
        for i, p in enumerate(PROMPTS):
            jengine.submit(jqueue.Request(f"r{i}", p, max_new_tokens=10))
        want = {r.request_id: list(r.tokens)
                for r in jengine.run_to_completion()}

        tcfg = ttr.TransformerConfig.tiny(dtype=torch.float32,
                                          attention_impl=impl)
        model = params_from_flax(jax.device_get(params), tcfg,
                                 device="cpu")
        engine = _engine(tcfg, model)
        for i, p in enumerate(PROMPTS):
            engine.submit(Request(f"r{i}", p, max_new_tokens=10))
        got = {r.request_id: list(r.tokens)
               for r in engine.run_to_completion()}
        assert got == want
        assert len(got) == 2 and all(len(t) == 10 for t in got.values())


# ---------------------------------------------------------------------------
# ServeEngine (CPU, tiny fp32 config)
# ---------------------------------------------------------------------------

class TestServeEngine:
    @pytest.mark.parametrize("impl", ["full", "flash"])
    def test_temp0_matches_no_cache_greedy(self, impl):
        cfg, model = _tiny(impl)
        engine = _engine(cfg, model)
        for i, p in enumerate(PROMPTS):
            engine.submit(Request(f"r{i}", p, max_new_tokens=10))
        results = {r.request_id: r for r in engine.run_to_completion()}
        assert len(results) == 2
        for i, p in enumerate(PROMPTS):
            r = results[f"r{i}"]
            assert r.outcome == "completed"
            assert list(r.tokens) == _greedy_reference(model, p, 10)
        assert engine.kv.ledger.blocks_in_use == 0
        assert engine.active_count == 0

    def test_continuous_join_mid_stream_and_no_leaks(self):
        cfg, model = _tiny()
        engine = _engine(cfg, model, num_slots=2)
        engine.submit(Request("long", (1, 2, 3), max_new_tokens=20))
        engine.submit(Request("s0", (4, 5), max_new_tokens=3))
        done = []
        for step in range(200):
            if step == 4:  # joins while "long" is mid-decode
                engine.submit(Request("s1", (6, 7), max_new_tokens=3))
            done.extend(engine.step())
            if len(done) == 3 and not engine.active_count:
                break
        by_id = {r.request_id: r for r in done}
        assert set(by_id) == {"long", "s0", "s1"}
        assert all(r.outcome == "completed" for r in done)
        order = [r.request_id for r in done]
        assert order.index("s1") < order.index("long")
        assert engine.kv.ledger.blocks_in_use == 0

    def test_drain_policy_completes_in_waves(self):
        cfg, model = _tiny()
        engine = _engine(cfg, model, num_slots=2, policy="drain")
        for i in range(4):
            engine.submit(Request(f"r{i}", (1, 2), max_new_tokens=4))
        results = engine.run_to_completion()
        assert len(results) == 4
        assert all(r.outcome == "completed" for r in results)
        assert engine.kv.ledger.blocks_in_use == 0

    def test_too_long_request_fails_at_admission(self):
        cfg, model = _tiny()
        engine = _engine(cfg, model, max_len=16)
        engine.submit(Request("huge", tuple(range(1, 13)),
                              max_new_tokens=8))  # 12 + 7 > 16
        results = engine.run_to_completion()
        assert [(r.outcome, r.reason) for r in results] == \
            [("failed", "too_long")]
        assert engine.kv.ledger.blocks_in_use == 0

    def test_cache_pressure_requeues_until_blocks_free(self):
        cfg, model = _tiny()
        # budget fits one 2-block request at a time
        engine = _engine(cfg, model, num_slots=2, max_len=16,
                         total_blocks=2)
        engine.submit(Request("a", tuple(range(1, 9)), max_new_tokens=4))
        engine.submit(Request("b", tuple(range(1, 9)), max_new_tokens=4))
        results = engine.run_to_completion()
        assert sorted(r.request_id for r in results) == ["a", "b"]
        assert all(r.outcome == "completed" for r in results)
        assert engine.kv.ledger.blocks_in_use == 0

    def test_deadline_mid_decode_fails_loudly(self):
        cfg, model = _tiny()
        clock = FakeClock()
        queue = AdmissionQueue(max_depth=8, admission_timeout_s=1e9,
                               clock=clock)
        engine = _engine(cfg, model, queue=queue, clock=clock)
        engine.submit(Request("slow", (1, 2), max_new_tokens=20,
                              deadline_s=5.0))
        engine.step()  # prefill + first decode, t=0
        clock.t = 6.0  # blow the deadline mid-stream
        results = []
        for _ in range(5):
            results.extend(engine.step())
            if results:
                break
        assert [(r.outcome, r.reason) for r in results] == \
            [("failed", "deadline")]
        assert engine.kv.ledger.blocks_in_use == 0

    def test_drain_mode_refuses_new_work_and_finishes_old(self):
        cfg, model = _tiny()
        engine = _engine(cfg, model)
        assert engine.submit(Request("a", (1, 2), max_new_tokens=3))
        engine.begin_drain()
        engine.begin_drain()  # idempotent
        assert engine.draining
        assert not engine.submit(Request("b", (3, 4)))
        results = engine.run_to_completion()
        assert [r.request_id for r in results] == ["a"]

    def test_single_token_request_retires_at_prefill(self):
        cfg, model = _tiny()
        engine = _engine(cfg, model)
        engine.submit(Request("one", (9, 8, 7), max_new_tokens=1))
        results = engine.run_to_completion()
        assert [(r.request_id, len(r.tokens), r.outcome)
                for r in results] == [("one", 1, "completed")]
        assert list(results[0].tokens) == _greedy_reference(
            model, (9, 8, 7), 1)

    def test_model_on_another_device_is_refused(self):
        cfg = ttr.TransformerConfig.tiny(dtype=torch.float32)
        model = ttr.init_params(cfg, device="meta")
        with pytest.raises(ValueError, match="model is on meta"):
            ServeEngine(cfg, model, device="cpu")


# ---------------------------------------------------------------------------
# SlotScheduler
# ---------------------------------------------------------------------------

class TestSlotScheduler:
    def test_join_assigns_each_slot_once(self):
        s = SlotScheduler(3)
        slots = [s.join(f"r{i}") for i in range(3)]
        assert sorted(slots) == [0, 1, 2]
        assert not s.can_join()
        with pytest.raises(RuntimeError):
            s.join("overflow")

    def test_retire_frees_for_immediate_reuse(self):
        s = SlotScheduler(2)
        a = s.join("a")
        s.join("b")
        s.retire(a)
        assert s.can_join()
        assert s.join("c") == a
        assert s.active[a] == "c"

    def test_retire_inactive_slot_raises(self):
        s = SlotScheduler(2)
        with pytest.raises(KeyError):
            s.retire(0)

    def test_continuous_joins_mid_wave(self):
        s = SlotScheduler(2, policy="continuous")
        s.join("a")
        s.begin_wave()
        assert s.can_join()

    def test_drain_blocks_joins_until_batch_empties(self):
        s = SlotScheduler(2, policy="drain")
        a = s.join("a")
        s.begin_wave()
        assert not s.can_join()
        with pytest.raises(RuntimeError):
            s.join("b")
        s.retire(a)
        assert s.can_join()
        s.join("b")

    def test_rejects_bad_policy_and_size(self):
        with pytest.raises(ValueError):
            SlotScheduler(2, policy="paged")
        with pytest.raises(ValueError):
            SlotScheduler(0)


# ---------------------------------------------------------------------------
# BlockLedger / KVCache
# ---------------------------------------------------------------------------

class TestBlockLedger:
    def test_alloc_grow_free_roundtrip_no_leak(self):
        led = BlockLedger(2, max_len=32, block_size=8)
        slot = led.alloc(5)
        assert slot is not None
        assert led.blocks_in_use == 1
        assert led.grow(slot, 9)
        assert led.blocks_in_use == 2
        assert led.length(slot) == 9
        led.free(slot)
        assert led.blocks_in_use == 0
        assert led.free_slots == 2

    def test_budget_refuses_oversubscription(self):
        led = BlockLedger(2, max_len=32, block_size=8, total_blocks=3)
        a = led.alloc(16)
        assert a is not None
        assert led.can_alloc(8)
        assert not led.can_alloc(9)
        b = led.alloc(8)
        assert b is not None
        assert not led.grow(b, 9)
        assert led.length(b) == 8
        led.free(a)
        assert led.grow(b, 9)

    def test_grow_refuses_past_max_len(self):
        led = BlockLedger(1, max_len=16, block_size=8)
        slot = led.alloc(8)
        assert led.grow(slot, 16)
        assert not led.grow(slot, 17)

    def test_double_free_and_unknown_grow_raise(self):
        led = BlockLedger(1, max_len=16, block_size=8)
        slot = led.alloc(4)
        led.free(slot)
        with pytest.raises(KeyError):
            led.free(slot)
        with pytest.raises(KeyError):
            led.grow(slot, 8)

    def test_alloc_at_claims_specific_slot(self):
        led = BlockLedger(3, max_len=16, block_size=8)
        led.alloc_at(1, 4)
        assert led.length(1) == 4
        with pytest.raises(KeyError):
            led.alloc_at(1, 4)
        with pytest.raises(KeyError):
            led.alloc_at(7, 4)
        led2 = BlockLedger(2, max_len=16, block_size=8, total_blocks=1)
        led2.alloc_at(0, 8)
        with pytest.raises(RuntimeError):
            led2.alloc_at(1, 8)

    def test_alloc_at_reserves_whole_life(self):
        led = BlockLedger(2, max_len=32, block_size=8, total_blocks=4)
        led.alloc_at(0, 4, reserve=20)  # 3 blocks held up front
        assert led.blocks_in_use == 3
        assert led.length(0) == 4
        assert not led.can_alloc(9)
        assert led.grow(0, 20) and led.blocks_in_use == 3

    def test_ledger_matches_jax_ledger(self):
        from horovod_tpu.serving.kv_cache import BlockLedger as JaxLedger
        ops = [("alloc", 5), ("alloc", 17), ("grow", 0, 12),
               ("grow", 1, 33), ("free", 0), ("alloc", 30)]

        def trace(ledger_cls):
            led = ledger_cls(3, max_len=32, block_size=8, total_blocks=7)
            return [(getattr(led, op[0])(*op[1:]), led.blocks_in_use)
                    for op in ops]
        assert trace(BlockLedger) == trace(JaxLedger)

    def test_kv_cache_shapes_follow_config(self):
        cfg = ttr.TransformerConfig.tiny(dtype=torch.float32)
        kv = KVCache(cfg, num_slots=3, max_len=32, block_size=8,
                     device="cpu")
        assert kv.k.shape == (cfg.num_layers, 3, 32, cfg.num_heads,
                              cfg.head_dim)
        assert kv.k.dtype == cfg.dtype
        assert kv.num_slots == 3
        assert kv.k.device.type == "cpu" and kv.v.shape == kv.k.shape


# ---------------------------------------------------------------------------
# AdmissionQueue
# ---------------------------------------------------------------------------

class TestAdmissionQueue:
    def test_rejects_when_full(self):
        q = AdmissionQueue(max_depth=1, admission_timeout_s=10.0,
                           clock=FakeClock())
        assert q.submit(Request("a", (1,)))
        assert not q.submit(Request("b", (1,)))
        assert q.rejected["queue_full"] == 1

    def test_pop_rejects_deadline_expired(self):
        clock = FakeClock()
        q = AdmissionQueue(max_depth=8, admission_timeout_s=5.0,
                           clock=clock)
        q.submit(Request("stale", (1,), deadline_s=1.0))
        q.submit(Request("fresh", (1,)))
        clock.t = 2.0
        assert q.pop().request_id == "fresh"
        assert q.rejected["deadline"] == 1
        assert q.pop() is None

    def test_requeue_goes_to_head(self):
        q = AdmissionQueue(max_depth=2, admission_timeout_s=10.0)
        q.submit(Request("a", (1,)))
        q.submit(Request("b", (1,)))
        first = q.pop()
        q.requeue(first)
        assert q.pop().request_id == "a"
        assert q.pop().request_id == "b"

    def test_len_counts_queued_requests(self):
        q = AdmissionQueue(max_depth=4, admission_timeout_s=10.0)
        q.submit(Request("a", (1,), max_new_tokens=40))
        q.submit(Request("b", (1,), max_new_tokens=8))
        assert len(q) == 2
        q.pop()
        assert len(q) == 1

    def test_env_knobs(self, monkeypatch):
        monkeypatch.setenv("HVD_SERVE_QUEUE_DEPTH", "3")
        monkeypatch.setenv("HOROVOD_SERVE_ADMISSION_TIMEOUT_S", "2.5")
        q = AdmissionQueue()
        assert q.max_depth == 3 and q.admission_timeout_s == 2.5


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

class TestSampling:
    def test_greedy_is_argmax_first_max(self):
        logits = torch.tensor([[0.1, 3.0, 3.0, -1.0], [5.0, 0.0, 0.0, 0.0]])
        got = sample_tokens(logits, np.zeros(2, np.float32))
        assert got.tolist() == [1, 0]

    def test_temperature_draws_are_seeded_and_per_row(self):
        r = np.random.RandomState(0)
        logits = torch.from_numpy(r.randn(4, 50).astype(np.float32))
        temps = np.array([0.0, 1.0, 0.0, 2.0], np.float32)
        a = sample_tokens(logits, temps, torch.Generator().manual_seed(3))
        b = sample_tokens(logits, temps, torch.Generator().manual_seed(3))
        assert a.tolist() == b.tolist()
        greedy = torch.argmax(logits, dim=-1)
        assert a[0] == greedy[0] and a[2] == greedy[2]
        assert all(0 <= t < 50 for t in a.tolist())


# ---------------------------------------------------------------------------
# the serve_lm entry point
# ---------------------------------------------------------------------------

class TestServeLmCli:
    def test_cpu_run_prints_one_json_line(self, capsys):
        from horovod_tpu_torch import serve_lm
        assert serve_lm.main(["--device", "cpu", "--requests", "6",
                              "--baseline"]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 1
        out = json.loads(lines[0])
        assert out["max_len"] == 64 and out["prompt_lens"] == [4, 8]
        for arm in ("continuous", "static"):
            assert out[arm]["completed"] == 6 and out[arm]["failed"] == 0
        # the CPU config attends with "full": no kernel is launched
        assert out["continuous"]["kernel_launches"] == {}

    def test_card_defaults_reach_the_multi_tile_kernel(self):
        from horovod_tpu_torch import serve_lm
        max_len, kv_block, (lo, hi) = serve_lm.serving_defaults("cuda")
        assert (max_len, kv_block) == (1024, 16)
        # one-tile (online) and multi-tile (lazy) prompts, and the longest
        # prompt plus the longest decode still fits the cache
        assert lo <= 64 < hi and hi + 40 <= max_len
