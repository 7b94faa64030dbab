"""horovod_tpu_torch's rank-0 negotiation (``ops/negotiation.py``)
against the JAX package's.

Without processes: the port's ``CoordinatorService`` and the JAX one are
fed the same metas and requests, and their response sequences must be
equal step for step — names, ops, fused groups, error responses, cache
ids, pruning, the shutdown drain, the response-log cap, liveness — and
the compact response wire must encode to the same bytes, each package
decoding the other's (the cases of ``tests/test_negotiation.py::
TestCoordinatorUnit``, ``TestResponseWire``, ``TestShutdownDrain`` and
``tests/test_response_cache.py::TestCoordinatorCache``, the quantized
codecs aside). The worker's backoff and its poisoning after sustained
unreachability (``TestPoisonGrace``) run on one rank with a failing
negotiator.

With processes: 2 gloo ranks and then 3, each set spawned once for the
module with ``HVD_SECRET_KEY`` and ``HVD_CONTROL_ADDR`` set, run the
multi-rank cases of ``tests/test_negotiation.py:313-635``: opposite and
rotated submission orders, a burst fused by the coordinator,
``broadcast_object`` riding the core, the response cache in steady
state and across a shape change, a meta mismatch, a subset that stalls
and does not hang, and a departing rank that drains what the
coordinator ordered before its peer's pending work fails with
ShutdownError. Every join has a deadline.
"""

import base64
import logging
import os
import socket
import time
import traceback

import pytest
import torch
import torch.multiprocessing as mp

from horovod_tpu_torch import mpi_ops
from horovod_tpu_torch.common.config import HorovodConfig as TConfig
from horovod_tpu_torch.common.exceptions import (MismatchError,
                                                 RanksLostError,
                                                 ShutdownError, StalledError)
from horovod_tpu_torch.ops import negotiation as tneg

KEY = b"k" * 32
JOIN_TIMEOUT_S = 120


# ---------------------------------------------------------------------------
# the coordinator unit, port and JAX side by side


class Pair:
    """A port and a JAX CoordinatorService under the same config; every
    call goes to both, and the results come back as (port, jax)."""

    def __init__(self, nproc=2, **cfg):
        from horovod_tpu.common.config import HorovodConfig as JConfig
        from horovod_tpu.ops import negotiation as jneg
        self.jneg = jneg
        base = dict(fusion_threshold=64 << 20, stall_warning_time_seconds=0)
        base.update(cfg)
        self.t = tneg.CoordinatorService(nproc, KEY, ports=[0],
                                         config=TConfig(**base))
        self.j = jneg.CoordinatorService(nproc, KEY, ports=[0],
                                         config=JConfig(**base))

    def metas(self, specs):
        """EntryMetas of ``specs`` [(name, op, dtype, shape, root, avg)]
        in each package."""
        return ([tneg.EntryMeta(*s) for s in specs],
                [self.jneg.EntryMeta(*s) for s in specs])

    def submit(self, rank, specs):
        tm, jm = self.metas(specs)
        self.t._submit(rank, tm)
        self.j._submit(rank, jm)

    def negotiate(self):
        self.t._negotiate()
        self.j._negotiate()
        self.check()

    def handle(self, rank, specs, ack, **kw):
        tm, jm = self.metas(specs)
        hits = kw.pop("hit_ids", None)
        if hits is not None:
            kw["hits"] = tneg.encode_hits(hits)
        got = self.t._handle(tneg.CycleRequest(rank, tm, ack, **kw),
                             ("127.0.0.1", 0))
        want = self.j._handle(self.jneg.CycleRequest(rank, jm, ack, **kw),
                              ("127.0.0.1", 0))
        # the same response, byte for byte on the wire
        assert tneg.encode_response(got) == self.jneg.encode_response(want)
        self.check()
        return got

    def check(self):
        assert _responses(self.t) == _responses(self.j)
        assert self.t._base_seq == self.j._base_seq
        assert self.t._cache_id_of == self.j._cache_id_of
        assert list(self.t._cache) == list(self.j._cache)
        assert self.t._next_cache_id == self.j._next_cache_id
        assert self.t._order == self.j._order
        assert sorted(self.t._table) == sorted(self.j._table)
        assert self.t._lost_ranks == self.j._lost_ranks
        assert self.t._shutdown == self.j._shutdown
        assert self.t._dump_requested == self.j._dump_requested

    def close(self):
        self.t.shutdown()
        self.j.shutdown()


def _responses(svc):
    return [(r.kind, r.op, list(r.names), r.error, r.cache_ids, r.codec)
            for r in svc._responses]


def _m(name, op="allreduce", dtype="float32", shape=(4,), root=0,
       average=False):
    return (name, op, dtype, shape, root, average)


@pytest.fixture
def pair(request):
    p = Pair(**getattr(request, "param", {}))
    yield p
    p.close()


class TestCoordinatorUnit:
    def test_holds_until_all_ranks_submit(self, pair):
        pair.submit(0, [_m("a")])
        pair.negotiate()
        assert pair.t._responses == []
        pair.submit(1, [_m("a")])
        pair.negotiate()
        assert [r.names for r in pair.t._responses] == [["a"]]

    def test_fuses_ready_same_dtype_allreduces(self, pair):
        specs = [_m(f"g{i}") for i in range(4)] + \
            [_m("d", dtype="float64"), _m("b", op="broadcast")]
        for rank in (0, 1):
            pair.submit(rank, specs)
        pair.negotiate()
        kinds = [(r.op, tuple(r.names)) for r in pair.t._responses]
        assert ("allreduce", ("g0", "g1", "g2", "g3")) in kinds
        assert ("allreduce", ("d",)) in kinds
        assert ("broadcast", ("b",)) in kinds

    @pytest.mark.parametrize("pair", [{"fusion_threshold": 32}],
                             indirect=True)
    def test_fusion_respects_threshold(self, pair):
        specs = [_m(f"g{i}") for i in range(4)]
        for rank in (0, 1):
            pair.submit(rank, specs)
        pair.negotiate()
        assert [r.names for r in pair.t._responses] == \
            [["g0", "g1"], ["g2", "g3"]]

    @pytest.mark.parametrize("pair", [{"fusion_threshold": 0}],
                             indirect=True)
    def test_zero_threshold_disables_fusion(self, pair):
        specs = [_m(f"g{i}") for i in range(3)]
        for rank in (0, 1):
            pair.submit(rank, specs)
        pair.negotiate()
        assert [r.names for r in pair.t._responses] == \
            [["g0"], ["g1"], ["g2"]]

    def test_average_and_sum_never_share_a_bucket(self, pair):
        specs = [_m("s0"), _m("m0", average=True), _m("s1"),
                 _m("m1", average=True)]
        for rank in (0, 1):
            pair.submit(rank, specs)
        pair.negotiate()
        assert sorted(r.names for r in pair.t._responses) == \
            [["m0", "m1"], ["s0", "s1"]]

    def test_meta_mismatch_becomes_error_response(self, pair):
        pair.submit(0, [_m("x", shape=(2, 3))])
        pair.submit(1, [_m("x", shape=(2, 4))])
        pair.negotiate()
        (r,) = pair.t._responses
        assert r.kind == r.ERROR
        assert "x" in r.error and "ConstructResponse" in r.error

    def test_response_log_pruned_after_all_ranks_ack(self, pair):
        dtypes = ["float32", "float64", "int32", "int64"]  # no fusion
        for i in range(4):
            for rank in (0, 1):
                pair.submit(rank, [_m(f"t{i}", dtype=dtypes[i])])
        pair.negotiate()
        assert len(pair.t._responses) == 4
        pair.handle(0, [], 2)
        pair.handle(1, [], 2)
        assert pair.t._base_seq == 3 and len(pair.t._responses) == 1
        resp = pair.handle(0, [], 2)
        assert resp.base_seq == 3 and len(resp.responses) == 1

    def test_allgather_first_dim_may_differ(self, pair):
        pair.submit(0, [_m("g", op="allgather", shape=(2, 3))])
        pair.submit(1, [_m("g", op="allgather", shape=(5, 3))])
        pair.negotiate()
        (r,) = pair.t._responses
        assert r.kind == r.EXECUTE

    def test_ready_allgathers_fuse_by_dtype(self, pair):
        specs = [_m("a", op="allgather", shape=(2, 3)),
                 _m("b", op="allgather", shape=(4,)),
                 _m("c", op="allgather", dtype="int32", shape=(1,))]
        for rank in (0, 1):
            pair.submit(rank, specs)
        pair.negotiate()
        assert [r.names for r in pair.t._responses] == [["a", "b"], ["c"]]

    @pytest.mark.parametrize("pair", [{"compression": "bf16"}],
                             indirect=True)
    def test_cast_codec_splits_fusion_buckets(self, pair):
        """Under HOROVOD_COMPRESSION=bf16 a float tensor at or above the
        size gate rides the bf16 wire and one below it full width, so
        they never share a fused buffer; integers are never cast."""
        specs = [_m("a", shape=(1024,)), _m("b", shape=(4,)),
                 _m("c", shape=(2048,)),
                 _m("ints", dtype="int32", shape=(1024,))]
        for rank in (0, 1):
            pair.submit(rank, specs)
        pair.negotiate()
        plans = {tuple(r.names): r.codec for r in pair.t._responses}
        assert plans == {("a", "c"): "bf16", ("b",): None,
                         ("ints",): None}

    def test_codec_fingerprint_mismatch_fails_ready_tensors(self, pair):
        fp0 = pair.t._codec_fp
        assert fp0 == pair.j._codec_fp == "none/b256/min1024/ef1"
        pair.handle(0, [_m("g")], -1, codec_fp=fp0)
        pair.handle(1, [_m("g")], -1, codec_fp="bf16/b256/min1024/ef1")
        (r,) = pair.t._responses
        assert r.kind == r.ERROR
        assert "Mismatched wire-codec config" in r.error
        # sticky: nothing ever executes under asymmetric codecs
        for rank in (0, 1):
            pair.submit(rank, [_m("h")])
        pair.negotiate()
        assert all(x.kind == x.ERROR for x in pair.t._responses)

    def test_matching_fingerprints_do_not_trip(self, pair):
        for rank in (0, 1):
            pair.handle(rank, [_m("g")], -1, codec_fp=pair.t._codec_fp)
        assert not pair.t._codec_mismatch
        (r,) = pair.t._responses
        assert r.kind == r.EXECUTE


class TestShutdownDrain:
    def test_coordinator_errors_newly_ready_after_shutdown(self, pair):
        pair.handle(0, [_m("pre")], -1, req_id=1)
        resp = pair.handle(1, [_m("pre")], -1, shutdown=True, req_id=1)
        assert resp.shutdown
        assert [r.kind for r in resp.responses] == ["execute"]
        pair.handle(0, [_m("post")], 0, req_id=2)
        resp = pair.handle(1, [_m("post")], 0, req_id=2)
        (err,) = resp.responses
        assert err.kind == err.ERROR and "shut down" in err.error

    @pytest.mark.parametrize("pair", [{"fusion_threshold": 0}],
                             indirect=True)
    def test_response_log_hard_cap_marks_laggards_stale(self, pair):
        pair.t.MAX_RESPONSE_LOG = pair.j.MAX_RESPONSE_LOG = 4
        for i in range(8):
            pair.handle(0, [_m(f"t{i}")], i - 1, req_id=10 + i)
            pair.handle(1, [_m(f"t{i}")], -1, req_id=10 + i)
        assert len(pair.t._responses) <= 4
        assert pair.handle(1, [], -1, req_id=99).stale_ack
        assert not pair.handle(0, [], 7, req_id=100).stale_ack


class TestLiveness:
    @pytest.mark.parametrize("pair", [{"rank_lost_timeout_seconds": 0.2}],
                             indirect=True)
    def test_silent_rank_is_declared_lost(self, pair):
        pair.handle(0, [_m("a")], -1, req_id=1)
        pair.handle(1, [], -1, req_id=1)
        time.sleep(0.4)
        resp = pair.handle(0, [], -1, req_id=2)
        assert tuple(resp.lost_ranks) == (1,)   # rank 0 just cycled
        (err,) = resp.responses
        assert err.kind == err.ERROR and "RanksLostError" in err.error
        with pytest.raises(RanksLostError):
            tneg.raise_if_ranks_lost(resp)

    @pytest.mark.parametrize(
        "pair", [{"stall_warning_time_seconds": 0.1}], indirect=True)
    def test_stall_raises_the_dump_flag(self, pair):
        pair.handle(0, [_m("late")], -1, req_id=1)
        time.sleep(0.2)
        resp = pair.handle(0, [], -1, req_id=2)
        assert resp.dump_requested


class TestCoordinatorCache:
    def test_execute_assigns_cache_ids(self, pair):
        for rank in (0, 1):
            pair.submit(rank, [_m("a")])
        pair.negotiate()
        (r,) = pair.t._responses
        assert r.kind == r.EXECUTE and r.cache_ids == [0]
        assert pair.t._cache_id_of == {"a": 0}

    def test_hit_resolves_to_cached_meta(self, pair):
        for rank in (0, 1):
            pair.handle(rank, [_m("a")], -1, req_id=1)
        for rank in (0, 1):
            resp = pair.handle(rank, [], -1, req_id=2, hit_ids=[0])
            assert resp.unknown_ids == ()
        assert pair.t._responses[1].names == ["a"]
        assert pair.t._responses[1].cache_ids == [0]

    def test_unknown_id_reported(self, pair):
        resp = pair.handle(0, [], -1, req_id=1, hit_ids=[5])
        assert resp.unknown_ids == (5,)
        assert pair.t._responses == []

    def test_changed_signature_invalidates_id(self, pair):
        for rank in (0, 1):
            pair.handle(rank, [_m("a", shape=(4,))], -1, req_id=1)
        for rank in (0, 1):
            pair.handle(rank, [_m("a", shape=(2,))], -1, req_id=2)
        assert 0 not in pair.t._cache
        assert pair.t._cache_id_of == {"a": 1}
        assert pair.handle(0, [], -1, req_id=3,
                           hit_ids=[0]).unknown_ids == (0,)

    @pytest.mark.parametrize("pair", [{"cache_capacity": 2}],
                             indirect=True)
    def test_capacity_evicts_lru_and_never_reuses_ids(self, pair):
        for i, name in enumerate(["a", "b", "c"]):
            for rank in (0, 1):
                pair.handle(rank, [_m(name)], i - 1, req_id=i + 1)
        assert sorted(pair.t._cache) == [1, 2]
        assert pair.t._next_cache_id == 3
        assert pair.handle(0, [], 2, req_id=9,
                           hit_ids=[0]).unknown_ids == (0,)

    @pytest.mark.parametrize("pair", [{"cache_capacity": 0}],
                             indirect=True)
    def test_capacity_zero_disables_caching(self, pair):
        for rank in (0, 1):
            pair.submit(rank, [_m("a")])
        pair.negotiate()
        (r,) = pair.t._responses
        assert r.cache_ids is None and not pair.t._cache

    def test_deduped_retry_returns_persisted_unknown_ids(self, pair):
        assert pair.handle(0, [], -1, req_id=1,
                           hit_ids=[5]).unknown_ids == (5,)
        assert pair.handle(0, [], -1, req_id=1,
                           hit_ids=[5]).unknown_ids == (5,)
        assert pair.handle(0, [], -1, req_id=2).unknown_ids == ()

    def test_retry_with_hits_is_idempotent(self, pair):
        for rank in (0, 1):
            pair.handle(rank, [_m("a")], -1, req_id=1)
        for _ in range(2):
            pair.handle(0, [], -1, req_id=2, hit_ids=[0])
        assert len(pair.t._table) == 1
        pair.handle(1, [], -1, req_id=2, hit_ids=[0])
        assert pair.t._base_seq + len(pair.t._responses) == 2


# ---------------------------------------------------------------------------
# the wire


def _full_response(neg):
    responses = [
        neg.NegotiatedResponse(neg.NegotiatedResponse.EXECUTE, "allreduce",
                               ["g0", "g1", "g2"], cache_ids=[0, 1, 7]),
        neg.NegotiatedResponse(neg.NegotiatedResponse.EXECUTE, "allreduce",
                               ["q0", "q1"], codec="bf16"),
        neg.NegotiatedResponse(neg.NegotiatedResponse.ERROR, "broadcast",
                               ["bad"], error="Mismatched broadcast 'bad'"),
        neg.NegotiatedResponse(neg.NegotiatedResponse.EXECUTE, "allgather",
                               ["ag", "ünï"]),
        neg.NegotiatedResponse(neg.NegotiatedResponse.EXECUTE, "future_op",
                               ["x"]),
    ]
    return neg.CycleResponse(
        base_seq=300, responses=responses, params=(64 << 20, 5.0),
        shutdown=False, stale_ack=True, dump_requested=True,
        unknown_ids=(5, 9, 1000), lost_ranks=(3,))


def _fields(resp):
    return (resp.base_seq, tuple(resp.params), resp.shutdown,
            resp.stale_ack, resp.dump_requested, tuple(resp.unknown_ids),
            tuple(resp.lost_ranks),
            [(r.kind, r.op, r.names, r.error, r.cache_ids, r.codec)
             for r in resp.responses])


class TestResponseWire:
    def test_same_bytes_as_jax(self):
        from horovod_tpu.ops import negotiation as jneg
        assert tneg.RESPONSE_WIRE_VERSION == jneg.RESPONSE_WIRE_VERSION
        for t, j in ((_full_response(tneg), _full_response(jneg)),
                     (tneg.CycleResponse(0, [], (0, 99.22), True),
                      jneg.CycleResponse(0, [], (0, 99.22), True))):
            assert tneg.encode_response(t) == jneg.encode_response(j)

    def test_each_decodes_the_others_bytes(self):
        from horovod_tpu.ops import negotiation as jneg
        t_bytes = tneg.encode_response(_full_response(tneg))
        j_bytes = jneg.encode_response(_full_response(jneg))
        assert _fields(jneg.decode_response(t_bytes)) == \
            _fields(tneg.decode_response(j_bytes)) == \
            _fields(_full_response(tneg))

    def test_roundtrip_through_pickle(self):
        import pickle
        resp = _full_response(tneg)
        assert _fields(pickle.loads(pickle.dumps(resp))) == _fields(resp)

    def test_version_mismatch_fails_loudly(self):
        payload = bytearray(tneg.encode_response(_full_response(tneg)))
        payload[0] = tneg.RESPONSE_WIRE_VERSION + 1
        with pytest.raises(ValueError, match="wire version"):
            tneg.decode_response(bytes(payload))
        with pytest.raises(ValueError):
            tneg.decode_response(b"")

    @pytest.mark.parametrize("seed", range(6))
    def test_hits_encode_as_jax(self, seed):
        import numpy as np
        from horovod_tpu.ops import negotiation as jneg
        rng = np.random.RandomState(seed)
        n = int(rng.randint(0, 60))
        ids = sorted(set(int(i) for i in rng.randint(0, [8, 64, 5000,
                                                         10 ** 6][seed % 4],
                                                     n)))
        data = tneg.encode_hits(ids)
        assert data == jneg.encode_hits(ids)
        assert tneg.decode_hits(data) == jneg.decode_hits(data) == ids

    @pytest.mark.parametrize("a,b,agree", [
        (_m("x", shape=(2, 3)), _m("x", shape=(2, 3)), True),
        (_m("x", shape=(2, 3)), _m("x", shape=(2, 4)), False),
        (_m("x", op="allgather", shape=(2, 3)),
         _m("x", op="allgather", shape=(5, 3)), True),
        (_m("x", dtype="float32"), _m("x", dtype="bfloat16"), False),
        (_m("x", op="broadcast", root=0), _m("x", op="broadcast", root=1),
         False),
        (_m("x", average=True), _m("x"), False)])
    def test_meta_agreement_as_jax(self, a, b, agree):
        from horovod_tpu.ops import negotiation as jneg
        assert tneg.EntryMeta(*a).agrees_with(tneg.EntryMeta(*b)) == \
            jneg.EntryMeta(*a).agrees_with(jneg.EntryMeta(*b)) == agree


def test_control_address_and_key_rules(monkeypatch):
    """HVD_CONTROL_ADDR pins the address; otherwise the rendezvous
    (HVD_COORDINATOR_ADDR, else torchrun's MASTER_ADDR:MASTER_PORT) +1000
    over 16 ports; the key is the base64 HVD_SECRET_KEY and never
    derived."""
    for var in ("HVD_CONTROL_ADDR", "HVD_COORDINATOR_ADDR", "MASTER_ADDR",
                "MASTER_PORT", "_HVD_SECRET_KEY", "HVD_SECRET_KEY",
                "HOROVOD_SECRET_KEY"):
        monkeypatch.delenv(var, raising=False)
    assert tneg.control_addresses() is None and tneg.control_key() is None
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert tneg.control_addresses() == [("10.0.0.1", p)
                                        for p in range(30500, 30516)]
    monkeypatch.setenv("HVD_COORDINATOR_ADDR", "h:1234")
    assert tneg.control_addresses()[0] == ("h", 2234)
    monkeypatch.setenv("HVD_CONTROL_ADDR", "c:77")
    assert tneg.control_addresses() == [("c", 77)]
    monkeypatch.setenv("HVD_SECRET_KEY", base64.b64encode(KEY).decode())
    assert tneg.control_key() == KEY


# ---------------------------------------------------------------------------
# the worker's backoff and poisoning, on one rank


class _FailingNegotiator:
    calls = 0

    def cycle(self, *a, **kw):
        _FailingNegotiator.calls += 1
        raise ConnectionRefusedError("control plane unreachable")

    def close(self):
        pass


@pytest.fixture
def failing_core():
    from horovod_tpu_torch.common import state
    mpi_ops.init(device="cpu")
    coord = state.global_state().coordinator
    coord._paused = True
    coord._negotiator = _FailingNegotiator()
    yield coord
    coord._negotiator = None
    mpi_ops.shutdown()


class TestPoisonGrace:
    def test_three_fast_failures_do_not_poison(self, failing_core):
        for _ in range(5):
            failing_core._cycle_backoff_until = 0.0
            failing_core._negotiated_flush_locked()
        assert failing_core._cycle_failures >= 3
        assert not failing_core._negotiation_dead
        assert failing_core._cycle_backoff_until > 0

    def test_sustained_unreachability_poisons(self, failing_core):
        h = failing_core.enqueue("orphan", "allreduce", torch.ones(2))
        failing_core._cycle_backoff_until = 0.0
        failing_core._negotiated_flush_locked()
        failing_core._cycle_fail_since = (
            time.monotonic() - failing_core.POISON_GRACE_S - 1.0)
        for _ in range(3):
            failing_core._cycle_backoff_until = 0.0
            failing_core._negotiated_flush_locked()
        assert failing_core._negotiation_dead
        # the pending work failed naming rank 0, and new work is refused
        with pytest.raises(RanksLostError, match=r"\[0\]"):
            failing_core.synchronize(h)
        with pytest.raises(ShutdownError):
            failing_core.enqueue("late", "allreduce", torch.ones(2))

    def test_backoff_defers_cycles(self, failing_core):
        failing_core._cycle_backoff_until = 0.0
        failing_core._negotiated_flush_locked()
        calls = _FailingNegotiator.calls
        failing_core._negotiated_flush_locked()
        assert _FailingNegotiator.calls == calls
        assert failing_core._cycle_backoff_until > time.monotonic() - 2.0


# ---------------------------------------------------------------------------
# ranks: the jobs each spawned rank runs, in order


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _coord():
    from horovod_tpu_torch.common import state
    return state.global_state().coordinator


def _opposite(r, world):
    names = ["A", "B"] if r == 0 else ["B", "A"]
    handles = {n: mpi_ops.allreduce_async(
        torch.full((3,), 1.0 + (n == "B") + r), average=False, name=n)
        for n in names}
    return {n: mpi_ops.synchronize(h)[0].item() for n, h in handles.items()}


def _rotated(r, world):
    names = ["X", "Y", "Z"]
    order = names[r:] + names[:r]
    handles = {n: mpi_ops.allreduce_async(
        torch.full((2,), float(ord(n)) + r), average=True, name=n)
        for n in order}
    return {n: mpi_ops.synchronize(h)[0].item() for n, h in handles.items()}


def _burst(r, world):
    before = _coord()._applied_seq
    handles = [mpi_ops.allreduce_async(torch.full((8,), float(i)),
                                       average=False, name=f"burst{i}")
               for i in range(6)]
    outs = [mpi_ops.synchronize(h)[0].item() for h in handles]
    return outs, _coord()._applied_seq - before


def _objects(r, world):
    obj = {"epoch": 7, "blob": list(range(50))} if r == 0 else None
    return mpi_ops.broadcast_object(obj, root_rank=0)


def _ragged(r, world):
    x = torch.arange(float(r + 1) * 3).reshape(r + 1, 3) + 10 * r
    y = torch.full((r + 2,), float(r), dtype=torch.float64)
    hx = mpi_ops.allgather_async(x, name="rag.x")
    hy = mpi_ops.allgather_async(y, name="rag.y")
    return mpi_ops.synchronize(hx).tolist(), mpi_ops.synchronize(hy).tolist()


def _steady_cache(r, world):
    outs = []
    for step in range(4):
        hs = [mpi_ops.allreduce_async(torch.full((4,), float(i + step)),
                                      average=False, name=f"cache{i}")
              for i in range(3)]
        outs.append([mpi_ops.synchronize(h)[0].item() for h in hs])
    hits = _coord()._neg_hit_count
    # the shape changes mid-run (a ragged last batch): the cache id is
    # invalidated and the tensor re-announced in full
    out = mpi_ops.allreduce(torch.ones(2), average=False, name="cache0")
    return outs, hits, out.tolist()


def _mismatch(r, world):
    try:
        mpi_ops.allreduce(torch.ones(3 + r), name="mismatch")
        return "completed"
    except MismatchError as exc:
        return "mismatch" if "ConstructResponse" in str(exc) else str(exc)


def _subset_stalls(r, world):
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    from horovod_tpu_torch.common import hvd_logging
    handler = Capture()
    hvd_logging.get_logger().addHandler(handler)
    try:
        mpi_ops.allreduce(torch.ones(2), name="common")
        result = "none"
        if r == 0:
            try:
                mpi_ops.allreduce(torch.ones(2), name="only0")
            except StalledError:
                result = "stalled"
        else:
            time.sleep(2.5)
        warned = any("only0" in m and "missing ranks" in m
                     for m in records)
        mpi_ops.allreduce(torch.ones(2), name="after")  # still in step
        return result, warned
    finally:
        hvd_logging.get_logger().removeHandler(handler)


def _drain_then_peer_shutdown(r, world):
    """Last job: rank 1 announces a tensor, pauses its loop and shuts
    down, whose final drain applies the EXECUTE rank 0 completes; rank
    0's next collective, which rank 1 never submits, fails with
    ShutdownError instead of hanging."""
    coord = _coord()
    if r == 1:
        mpi_ops.allreduce_async(torch.full((2,), 2.0), average=False,
                                name="drained")
        time.sleep(0.5)         # the announcement cycle runs
        coord._paused = True    # the loop can no longer apply it
        time.sleep(1.0)         # rank 0 blocks in the collective
        mpi_ops.shutdown()      # the drain applies the EXECUTE
        return "shutdown-drained"
    time.sleep(0.8)
    out = mpi_ops.allreduce(torch.full((2,), 1.0), average=False,
                            name="drained")[0].item()
    try:
        mpi_ops.allreduce(torch.ones(2), name="waiting")
        return out, "completed"
    except ShutdownError:
        return out, "shutdown"


JOBS = {2: ("opposite", "burst", "objects", "ragged", "steady_cache",
            "mismatch", "subset_stalls", "drain_then_peer_shutdown"),
        3: ("rotated", "ragged")}


def _worker(r, world, port, cport, results):
    torch.set_num_threads(1)
    os.environ["HVD_CONTROL_ADDR"] = f"localhost:{cport}"
    os.environ["HVD_SECRET_KEY"] = base64.b64encode(KEY).decode()
    os.environ["HOROVOD_STALL_CHECK_TIME_SECONDS"] = "0.5"
    os.environ["HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"] = "1.5"
    report = {}
    try:
        mpi_ops.init(device="cpu", rank=r, size=world,
                     init_method=f"tcp://localhost:{port}")
        report["negotiated"] = _coord().negotiated
        for name in JOBS[world]:
            try:
                report[name] = globals()["_" + name](r, world)
            except Exception:  # noqa: BLE001 — reported to the parent
                report[name] = traceback.format_exc()
        mpi_ops.shutdown()
    except Exception:  # noqa: BLE001
        report["init"] = traceback.format_exc()
    results.put((r, report))


def _spawn(world):
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port, cport = _free_port(), _free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, cport,
                                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(world):
            r, report = results.get(timeout=JOIN_TIMEOUT_S)
            got[r] = report
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    assert sorted(got) == list(range(world))
    for r in range(world):
        assert "init" not in got[r], got[r]["init"]
        assert got[r]["negotiated"] is True
    return got


@pytest.fixture(scope="module")
def two():
    return _spawn(2)


@pytest.fixture(scope="module")
def three():
    return _spawn(3)


def _report(reports, name):
    for r, rep in reports.items():
        assert not isinstance(rep[name], str) or name == "mismatch" or \
            not rep[name].startswith("Traceback"), f"rank {r}:\n{rep[name]}"
    return [reports[r][name] for r in sorted(reports)]


class TestAnyOrderSubmission:
    def test_ranks_submit_in_opposite_order(self, two):
        for res in _report(two, "opposite"):
            assert res == {"A": 2.0 + 1.0, "B": 4.0 + 1.0}

    def test_three_ranks_rotated_orders(self, three):
        want = {n: float(ord(n)) + 1.0 for n in "XYZ"}
        for res in _report(three, "rotated"):
            assert res == want

    def test_burst_is_fused_by_coordinator(self, two):
        for outs, n_responses in _report(two, "burst"):
            assert outs == [2.0 * i for i in range(6)]
            assert n_responses < 6, n_responses

    def test_broadcast_object_rides_the_core(self, two):
        want = {"epoch": 7, "blob": list(range(50))}
        assert _report(two, "objects") == [want, want]

    @pytest.mark.parametrize("world", [2, 3])
    def test_ragged_allgathers_fuse_and_unfuse(self, two, three, world):
        reports = two if world == 2 else three
        want_x = torch.cat([torch.arange(float(r + 1) * 3).reshape(r + 1, 3)
                            + 10 * r for r in range(world)]).tolist()
        want_y = torch.cat([torch.full((r + 2,), float(r),
                                       dtype=torch.float64)
                            for r in range(world)]).tolist()
        for x, y in _report(reports, "ragged"):
            assert x == want_x and y == want_y


class TestNegotiatedCache:
    def test_steady_state_uses_hits_and_stays_correct(self, two):
        for outs, hits, changed in _report(two, "steady_cache"):
            assert outs == [[2.0 * (i + s) for i in range(3)]
                            for s in range(4)]
            assert hits >= 9   # steps 2-4 announced as cache bits
            assert changed == [2.0, 2.0]


class TestNegotiatedFailure:
    def test_meta_mismatch_fails_both_ranks(self, two):
        assert _report(two, "mismatch") == ["mismatch", "mismatch"]

    def test_subset_submission_stalls_not_hangs(self, two):
        (r0, warned0), (r1, _) = _report(two, "subset_stalls")
        assert r0 == "stalled" and r1 == "none"
        assert warned0 is True

    def test_departing_rank_drains_then_peer_fails_pending(self, two):
        (out, after), departed = _report(two, "drain_then_peer_shutdown")
        assert departed == "shutdown-drained"
        assert out == 3.0
        assert after == "shutdown"
