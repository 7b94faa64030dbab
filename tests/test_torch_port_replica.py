"""horovod_tpu_torch's serving replica group (``serving/replica.py``)
and the engine's failover hook, as ``horovod_tpu/serving/replica.py``
and ``ServeEngine(replica=, on_ranks_lost=)`` behave: replicas heartbeat
a rank-0 coordinator over the authenticated wire; a silent replica is
declared lost within its timeout and every survivor's next heartbeat
raises RanksLostError naming it; the heartbeat's load snapshot lands in
rank 0's ledger; an engine turns the error into its callback and keeps
serving. The replicas here are objects of one process on localhost.
"""

import time

import pytest
import torch

from horovod_tpu_torch.common.exceptions import RanksLostError
from horovod_tpu_torch.run import network
from horovod_tpu_torch.serving import ReplicaGroup, Request, ServeEngine

KEY = b"r" * 32


def _group(world=2, timeout=0.6):
    addr = ("127.0.0.1", network.free_port())
    return [ReplicaGroup(r, world, addr, key=KEY, rank_lost_timeout_s=timeout,
                         start_timeout_s=10.0) for r in range(world)]


@pytest.fixture
def group():
    g = _group()
    yield g
    for rep in g:
        rep.close(linger_s=0.0)


def test_needs_a_key(monkeypatch):
    for var in ("_HVD_SECRET_KEY", "HVD_SECRET_KEY", "HOROVOD_SECRET_KEY"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="HMAC key"):
        ReplicaGroup(0, 1, ("127.0.0.1", network.free_port()))


def test_silent_replica_raises_ranks_lost_within_its_timeout(group):
    r0, r1 = group
    for _ in range(2):
        r0.heartbeat()
        r1.heartbeat()
    t0 = time.monotonic()   # rank 1 goes silent from here
    lost = None
    while time.monotonic() - t0 < 5.0:
        try:
            r0.heartbeat()
        except RanksLostError as err:
            lost = err
            break
        time.sleep(0.05)
    assert lost is not None and lost.ranks == (1,)
    assert time.monotonic() - t0 < 0.6 + 0.5
    # the declaration is sticky: rank 1's late heartbeat hears it too
    with pytest.raises(RanksLostError):
        r1.heartbeat()


def test_heartbeat_load_lands_in_rank0_ledger(group):
    r0, r1 = group
    r1.heartbeat(load={"queue_depth": 3, "free_slots": 1})
    r0.heartbeat(load={"queue_depth": 0, "free_slots": 4})
    loads = r0.peer_loads()
    assert loads[1]["queue_depth"] == 3 and loads[0]["free_slots"] == 4
    assert "ts" in loads[1]
    assert r1.peer_loads() == {}   # the ledger lives at rank 0
    assert r0.service is not None and r1.service is None


def _engine(replica, lost):
    from horovod_tpu_torch.models import transformer as tr
    cfg = tr.TransformerConfig.tiny(dtype=torch.float32,
                                    attention_impl="full")
    model = tr.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    return ServeEngine(cfg, model, num_slots=2, max_len=64, device="cpu",
                       replica=replica, on_ranks_lost=lost.append)


class _Lost:
    closed = False

    def heartbeat(self, load=None):
        assert "queue_depth" in load and "free_blocks" in load
        raise RanksLostError([2], reason="drill")

    def close(self):
        _Lost.closed = True


def test_engine_turns_ranks_lost_into_failover():
    lost = []
    engine = _engine(_Lost(), lost)
    engine.submit(Request("a", (5, 9, 17), max_new_tokens=3))
    done = engine.run_to_completion()
    assert lost == [(2,)] and _Lost.closed
    assert [r.request_id for r in done] == ["a"]   # and it kept serving


def test_engine_heartbeats_a_live_group_every_step(group):
    r0, r1 = group
    lost = []
    engine = _engine(r1, lost)
    r0.heartbeat()
    engine.submit(Request("b", (1, 2, 3, 4), max_new_tokens=2))
    engine.run_to_completion()
    assert lost == []
    assert r0.peer_loads()[1]["total_blocks"] == engine.kv.ledger.total_blocks
