"""Router plane of the port: N serve replicas behind one admission point.

The port of ``horovod_tpu/router``, host-side logic over the engines'
load snapshots, with the JAX package's decisions, events and metrics.
``Router`` (core.py) dispatches requests over live load snapshots with
cache-affinity stickiness, reroutes on replica loss, and, through
``CanaryController`` (canary.py), rolls weight generations out by traffic
fraction, gated on live SLO histograms. ``ElasticityController`` and
``CircuitBreaker`` (elastic.py) close the loop from SLO pressure to
replica-set changes: autoscaling with graceful drain, overload shedding
and per-replica breakers. Policies live in policy.py.
"""

from .canary import CanaryController, SLOWindow, slo_breaches
from .core import ReplicaHandle, Router
from .elastic import CircuitBreaker, ElasticityController
from .policy import (AFFINITY_SLACK, POLICIES, LeastLoaded, RoundRobin,
                     prefix_key, resolve, score)

__all__ = [
    "Router", "ReplicaHandle", "CanaryController", "SLOWindow",
    "slo_breaches", "ElasticityController", "CircuitBreaker",
    "resolve", "score", "prefix_key", "RoundRobin", "LeastLoaded",
    "POLICIES", "AFFINITY_SLACK",
]
