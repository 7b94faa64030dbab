"""Replica-group liveness for serving, on the negotiation control plane.

The port of ``horovod_tpu/serving/replica.py``. A group of serving
replicas has the same failure-detection problem the training job
already solved: a silent peer must become a LOUD, bounded-time error,
never a hang. Each replica runs a NegotiationWorker heartbeat against
the rank-0 replica's CoordinatorService (``ops/negotiation.py``); the
coordinator declares a silent replica lost after
``rank_lost_timeout_s``, and every surviving replica's next heartbeat
raises RanksLostError naming the dead ranks.

The engine (``serving/engine.py``) calls ``heartbeat()`` once per step
and turns the error into failover: it hands the lost ranks to the
``on_ranks_lost`` callback and keeps serving. Each heartbeat is one
``heartbeat`` span (``serving/tracing.py``), so a slow control plane
shows in the request-path story, and a RanksLost heartbeat aborts it.
"""

from ..common.config import HorovodConfig
from ..ops import negotiation as neg
from . import tracing as serve_tracing


class ReplicaGroup:
    """Membership + liveness for ``world`` serving replicas.

    ``address`` is the rank-0 replica's (host, port) control endpoint;
    rank 0 hosts the coordinator there (NegotiationWorker does this
    internally). ``key`` authenticates the control wire — pass the
    job's secret, or rely on neg.control_key() (HVD_SECRET_KEY).
    ``subscriber`` (``fleet.WeightSubscriber``) is the replica's weight
    subscription, which its ``ServeEngine`` takes.
    """

    def __init__(self, rank, world, address, key=None,
                 rank_lost_timeout_s=2.0, start_timeout_s=60.0,
                 config=None, subscriber=None):
        self.rank = rank
        self.world = world
        # the replica's weight subscription (fleet/subscriber.py): the
        # engine picks it up from here, so wiring a replica into the
        # fleet plane is one constructor argument
        self.subscriber = subscriber
        if key is None:
            key = neg.control_key()
        if key is None:
            raise ValueError(
                "ReplicaGroup needs an HMAC key: pass key= or export "
                "HVD_SECRET_KEY (the control wire deserializes pickles "
                "and must never run unauthenticated)")
        if config is None:
            config = HorovodConfig(
                fusion_threshold=0, stall_warning_time_seconds=0,
                rank_lost_timeout_seconds=rank_lost_timeout_s)
        self._worker = neg.NegotiationWorker(
            rank, world, config, [tuple(address)], key,
            start_timeout_s=start_timeout_s)
        self._req_id = 1

    @property
    def service(self):
        """Rank 0's CoordinatorService (None elsewhere)."""
        return self._worker.service

    def heartbeat(self, load=None):
        """One liveness cycle. Raises RanksLostError (naming the dead
        ranks) once the coordinator's ledger declares peers lost; any
        transport error surfaces to the caller too — silence is the one
        thing this method must never produce. ``load`` (a compact dict,
        ``ServeEngine.load_snapshot``) piggybacks on the cycle into the
        coordinator's per-replica ledger."""
        with serve_tracing.heartbeat_span(replica=self.rank):
            resp = self._worker.cycle([], -1, req_id=self._req_id,
                                      load=load)
            self._req_id += 1
            neg.raise_if_ranks_lost(resp)
        return resp

    def peer_loads(self):
        """The coordinator's per-replica load ledger ({rank: snapshot},
        each with the coordinator-receipt ``ts``), on rank 0; {}
        elsewhere."""
        service = self._worker.service
        if service is None:
            return {}
        return service.load_snapshot_view()

    def close(self, linger_s=0.5):
        self._worker.close(linger_s=linger_s)
