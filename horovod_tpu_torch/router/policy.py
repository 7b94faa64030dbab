"""Dispatch scoring for the router plane, the port of
``horovod_tpu/router/policy.py``.

A policy answers ONE question (given the live candidate replicas and
their load snapshots, which replica takes the next request) and nothing
else: liveness, reroute and canary cohort restriction all happen in the
Router before a policy is consulted, so policies stay pure scoring math.

Two baselines, selectable via ``HVD_ROUTE_POLICY``:

  * ``round_robin``   ignore load, cycle the candidate set in id order:
    the control arm any smarter policy must beat.
  * ``least_loaded``  pick the minimum dispatch cost ``score()``: a
    queued request weighs ``QUEUE_WEIGHT`` x an active slot (it has not
    started its TTFT clock), every outstanding decode token adds
    ``WORK_WEIGHT`` (the cost-awareness that spreads long requests),
    and a replica out of free KV blocks takes a flat
    ``KV_EXHAUSTED_PENALTY`` because an admit there parks in its queue
    until a retirement frees blocks.

Cache-affinity stickiness (``prefix_key``) layers on top of either policy
in the Router: requests sharing a prompt prefix prefer the replica that
saw the prefix first, but only while the sticky replica's score is within
``AFFINITY_SLACK`` of the policy's own pick, so affinity can never pin a
hot replica into a convoy.
"""

from ..common import config

# dispatch-cost weights (score): a queued request is work that has not
# started, so it predicts more future occupancy than an active slot
# mid-decode; the work term prices each outstanding decode token so a
# 40-token request weighs five 8-token ones (queue depth alone cannot
# tell them apart); KV exhaustion means the next admit stalls regardless
# of slots, which outweighs any queue-depth difference.
QUEUE_WEIGHT = 4.0
SLOT_WEIGHT = 1.0
WORK_WEIGHT = 0.125
KV_EXHAUSTED_PENALTY = 64.0
# affinity may override the policy pick only within this much extra
# cost — two queued requests' worth; past that, load wins over warmth
AFFINITY_SLACK = 2 * QUEUE_WEIGHT


def score(load):
    """Dispatch cost of one replica's load snapshot — lower wins.
    Missing/None snapshots score 0.0 (an unreported replica is assumed
    idle rather than excluded: brand-new replicas must be routable
    before their first heartbeat lands)."""
    if not load:
        return 0.0
    cost = (QUEUE_WEIGHT * float(load.get("queue_depth") or 0) +
            SLOT_WEIGHT * float(load.get("active_slots") or 0) +
            WORK_WEIGHT * float(load.get("work_tokens") or 0))
    free_blocks = load.get("free_blocks")
    if free_blocks is not None and free_blocks <= 0:
        cost += KV_EXHAUSTED_PENALTY
    return cost


def prefix_key(prompt, k):
    """Cache-affinity key: the request's first ``k`` prompt tokens,
    hashable and deterministic across processes. None (no stickiness)
    for k <= 0 or an empty prompt."""
    if k <= 0 or not prompt:
        return None
    return tuple(prompt[:k])


class RoundRobin:
    """Cycle the candidate set in replica-id order, load-blind."""

    name = "round_robin"

    def __init__(self):
        self._turn = 0

    def choose(self, candidates, loads):
        order = sorted(candidates)
        pick = order[self._turn % len(order)]
        self._turn += 1
        return pick


class LeastLoaded:
    """Minimum dispatch cost, replica id as the deterministic
    tie-break (two idle replicas always resolve the same way)."""

    name = "least_loaded"

    def choose(self, candidates, loads):
        return min(sorted(candidates),
                   key=lambda r: (score(loads.get(r)), r))


POLICIES = {"round_robin": RoundRobin, "least_loaded": LeastLoaded}


def resolve(name=None):
    """Instantiate the dispatch policy — ``name`` wins, else
    ``HVD_ROUTE_POLICY`` (default least_loaded). Unknown names fail
    loud: a typo'd policy silently falling back to a default would
    invalidate every A/B comparison made with it."""
    if name is None:
        name = config.env_str("ROUTE_POLICY", "least_loaded")
    try:
        return POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown route policy {name!r} (HVD_ROUTE_POLICY): "
            f"expected one of {sorted(POLICIES)}") from None
