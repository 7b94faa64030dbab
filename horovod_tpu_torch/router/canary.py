"""SLO-gated canary rollout as a routing decision, the port of
``horovod_tpu/router/canary.py``.

The fleet plane swaps a replica to a new weight generation the moment it
arms. This controller turns that cliff into a graded rollout: the cohort
decode keeps two generations serving side by side, the load snapshot says
who has the new generation armed, and the router decides who receives
traffic. State machine over generations::

    idle --G' armed--> canary --healthy window--> promoted (gates open)
                          |
                          +------SLO breach-----> rolled_back
                                                  (G' quarantined)

In ``canary`` the controller (a) holds every replica OUTSIDE the canary
cohort on the old weights through the engines' ``swap_gate`` hook, and
(b) steers ``HVD_ROUTE_CANARY_PCT`` percent of traffic (a deterministic
hash of the request id, so a request's cohort never flaps) to the cohort.
Completed results accumulate into per-cohort SLO histograms (TTFT,
inter-token, goodput tokens); once both cohorts have
``HVD_ROUTE_CANARY_WINDOW`` observations the verdict is histogram math:

    breach:  canary p99 TTFT        >  TTFT_X x baseline
             canary p99 inter-token >  the same multiplier x baseline
             canary goodput ratio   <  baseline - GOODPUT_DROP

(``HVD_ROUTE_CANARY_TTFT_X``, ``HVD_ROUTE_CANARY_GOODPUT_DROP``).

A latency breach also needs an absolute gap above
``HVD_ROUTE_CANARY_MIN_DELTA_S``: fixed-bucket p99s are quantized to
bucket edges, so two statistically identical populations can read as a
large ratio.

Any breach rolls back: traffic fraction to 0 and the generation
quarantined (replicas already serving it get no traffic until a newer
generation arms). No breach promotes: every gate opens and the fleet
converges on G'. Both verdicts emit an event (``route_promote`` /
``route_rollback``) carrying the evidence (the p99s, ratios, sample
counts and thresholds the decision was made from).
"""

import hashlib
import time

from ..common import config
from ..utils import metrics as hvd_metrics


def _hash_pct(request_id):
    """Deterministic [0, 100) bucket for a request id — the cohort
    split must be stable across retries and processes, never random."""
    digest = hashlib.blake2s(str(request_id).encode()).hexdigest()
    return int(digest[:8], 16) % 100


def intertoken_gap(result):
    """Mean inter-token gap of one completed RequestResult, or None
    when it has fewer than two tokens or no phase breakdown."""
    tokens = len(result.tokens)
    if tokens > 1 and result.phase_ms:
        return result.phase_ms.get("decode", 0.0) / 1e3 / (tokens - 1)
    return None


class SLOWindow:
    """One cohort's SLO accumulator: TTFT + inter-token histograms and
    goodput/wasted token counts over a window of terminal results.

    Shared between the canary rollout (per-cohort windows) and the
    elasticity controller (before/after windows around a topology
    change, router/elastic.py) so a scale decision is graded by
    EXACTLY the math that grades a weight rollout — one definition of
    "the SLO got worse", not two that drift."""

    __slots__ = ("ttft", "intertoken", "goodput_tokens",
                 "wasted_tokens", "n")

    def __init__(self):
        buckets = hvd_metrics.SERVE_PHASE_BUCKETS
        self.ttft = hvd_metrics.Histogram(buckets)
        self.intertoken = hvd_metrics.Histogram(buckets)
        self.goodput_tokens = 0
        self.wasted_tokens = 0
        self.n = 0

    def observe(self, result):
        """Fold one terminal RequestResult in. Returns the inter-token
        gap it contributed (None if none) so callers can mirror the
        observation into their own cumulative metrics."""
        tokens = len(result.tokens)
        gap = None
        if result.outcome == "completed":
            self.goodput_tokens += tokens
            if result.ttft_s is not None:
                self.ttft.observe(result.ttft_s)
            gap = intertoken_gap(result)
            if gap is not None:
                self.intertoken.observe(gap)
        else:
            self.wasted_tokens += tokens
        self.n += 1
        return gap

    def ttft_p99(self):
        return hvd_metrics.histogram_quantile(
            self.ttft.bounds, self.ttft.counts, 0.99)

    def intertoken_p99(self):
        return hvd_metrics.histogram_quantile(
            self.intertoken.bounds, self.intertoken.counts, 0.99)

    def goodput_ratio(self):
        total = self.goodput_tokens + self.wasted_tokens
        return self.goodput_tokens / total if total else 1.0


def slo_breaches(candidate, baseline, ttft_x, min_delta_s, goodput_drop):
    """The shared verdict: which SLO dimensions did ``candidate`` (an
    SLOWindow) breach against ``baseline``? A latency breach needs both
    the ratio (> ``ttft_x``) and an absolute gap (> ``min_delta_s``):
    fixed-bucket p99s quantize to bucket edges, so two statistically
    identical sub-bucket populations can read as a large *ratio* — the
    delta floor keeps the verdict above the histogram's resolution."""
    breaches = []
    for key, c, b in (
            ("ttft_p99", candidate.ttft_p99(), baseline.ttft_p99()),
            ("intertoken_p99", candidate.intertoken_p99(),
             baseline.intertoken_p99())):
        if (c is not None and b is not None and
                c > ttft_x * b and c - b > min_delta_s):
            breaches.append(key)
    if candidate.goodput_ratio() < baseline.goodput_ratio() - goodput_drop:
        breaches.append("goodput_ratio")
    return breaches


class CanaryController:
    """Owns the rollout state machine; the Router consults ``filter``
    per dispatch and feeds ``observe``/``tick``; engines take
    ``gate(replica_id)`` as their ``swap_gate``.

    ``max_canary_replicas`` bounds the cohort when every replica arms
    the new generation at once (the shared-directory fleet): the first
    k armed replica ids canary, the rest hold as baseline.
    """

    def __init__(self, pct=None, window=None, ttft_x=None,
                 goodput_drop=None, max_canary_replicas=None,
                 min_delta_s=None, clock=time.monotonic):
        self.pct = (config.env_float("ROUTE_CANARY_PCT", 10.0)
                    if pct is None else float(pct))
        self.window = (config.env_int("ROUTE_CANARY_WINDOW", 24)
                       if window is None else int(window))
        self.ttft_x = (config.env_float("ROUTE_CANARY_TTFT_X", 1.5)
                       if ttft_x is None else float(ttft_x))
        self.goodput_drop = (
            config.env_float("ROUTE_CANARY_GOODPUT_DROP", 0.10)
            if goodput_drop is None else float(goodput_drop))
        self.max_canary_replicas = (
            config.env_int("ROUTE_CANARY_REPLICAS", 1)
            if max_canary_replicas is None else int(max_canary_replicas))
        self.min_delta_s = (
            config.env_float("ROUTE_CANARY_MIN_DELTA_S", 0.025)
            if min_delta_s is None else float(min_delta_s))
        self._clock = clock
        self.state = "idle"
        self.canary_generation = None
        self.canary_replicas = frozenset()
        self.quarantined = set()   # generations rolled back for good
        self.decisions = []        # (verdict, evidence) history
        self._began_ts = None
        self._stats = None
        reg = self._metrics = hvd_metrics.get_registry()
        self._m_fraction = reg.gauge(
            "hvd_route_canary_fraction",
            "Percent of traffic routed to the canary weight "
            "generation (0 outside a rollout).")
        self._m_fraction.set(0)
        self._m_state = reg.gauge(
            "hvd_route_canary_generation",
            "Generation under canary evaluation (-1 when idle).")
        self._m_state.set(-1)
        # cumulative per-cohort SLO view for hvd_top; the DECISION uses
        # the per-window histograms in _stats, reset each rollout
        self._m_ttft = reg.histogram(
            "hvd_route_canary_ttft_seconds",
            "TTFT of completed requests during canary evaluation, by "
            "cohort.", labels=("cohort",),
            buckets=hvd_metrics.SERVE_PHASE_BUCKETS)
        self._m_intertoken = reg.histogram(
            "hvd_route_canary_intertoken_seconds",
            "Mean inter-token gap of completed requests during canary "
            "evaluation, by cohort.", labels=("cohort",),
            buckets=hvd_metrics.SERVE_PHASE_BUCKETS)

    # -- swap gating (ServeEngine swap_gate hook) -----------------------

    def gate(self, replica_id):
        """The ``swap_gate`` for one engine: closes over the replica id
        so ``allows_swap`` can tell cohort members from holdbacks."""
        rid = int(replica_id)

        def _gate(generation):
            return self.allows_swap(rid, generation)

        return _gate

    def allows_swap(self, replica_id, generation):
        if generation in self.quarantined:
            return False
        if self.canary_generation is None or \
                generation > self.canary_generation:
            # armed after this step's tick (the loader is a thread of its
            # own): held until the next tick claims it, never let through
            # a gate that is idle only because the tick came first. The
            # JAX package lets it through, and that replica then serves
            # the baseline cohort on the new weights
            return False
        if (self.state == "canary" and
                generation == self.canary_generation):
            return replica_id in self.canary_replicas
        return True

    # -- dispatch-side hooks (called by the Router) ---------------------

    def filter(self, request_id, candidates, loads):
        """Restrict dispatch candidates per the rollout state. The
        quarantine always applies; in ``canary`` the request's hash
        bucket decides its cohort. Falls back to the widest non-empty
        set — availability beats rollout discipline (a canary must
        never be the reason a request has nowhere to go)."""
        usable = [r for r in candidates
                  if (loads.get(r) or {}).get("generation")
                  not in self.quarantined]
        if self.state != "canary":
            return usable or candidates
        to_canary = _hash_pct(request_id) < self.pct
        cohort = [r for r in usable
                  if (r in self.canary_replicas) == to_canary]
        return cohort or usable or candidates

    def tick(self, loads):
        """Watch the fleet for a new generation arming (idle side) —
        the entry edge of the state machine."""
        if self.state == "canary":
            return
        floor = (self.canary_generation
                 if self.canary_generation is not None else -1)
        armed = {r: load.get("armed_generation")
                 for r, load in loads.items()
                 if load and load.get("armed_generation") is not None}
        fresh = {r: g for r, g in armed.items()
                 if g > floor and g not in self.quarantined}
        if not fresh:
            return
        gen = max(fresh.values())
        cohort = sorted(r for r, g in fresh.items() if g == gen)
        self._begin(gen, cohort[:max(self.max_canary_replicas, 1)])

    def observe(self, result, replica_id):
        """One terminal RequestResult lands in its cohort's window
        histograms; cohort membership is the GENERATION that decoded
        it, so pre-swap admissions on a canary replica still count as
        baseline. May decide (promote/rollback) once both windows
        fill."""
        if self.state != "canary":
            return
        cohort = ("canary" if result.generation == self.canary_generation
                  else "baseline")
        gap = self._stats[cohort].observe(result)
        if result.outcome == "completed" and result.ttft_s is not None:
            self._m_ttft.labels(cohort=cohort).observe(result.ttft_s)
        if gap is not None:
            self._m_intertoken.labels(cohort=cohort).observe(gap)
        self._maybe_decide()

    # -- the decision ---------------------------------------------------

    def _begin(self, generation, cohort):
        self.state = "canary"
        self.canary_generation = int(generation)
        self.canary_replicas = frozenset(int(r) for r in cohort)
        self._began_ts = self._clock()
        self._stats = {name: SLOWindow()
                       for name in ("canary", "baseline")}
        self._m_fraction.set(self.pct)
        self._m_state.set(self.canary_generation)
        self._metrics.event(
            "route_canary_begin", generation=self.canary_generation,
            replicas=sorted(self.canary_replicas), pct=self.pct,
            window=self.window)

    def _maybe_decide(self):
        can, base = self._stats["canary"], self._stats["baseline"]
        if can.n < self.window or base.n < self.window:
            return
        evidence = {
            "generation": self.canary_generation,
            "replicas": sorted(self.canary_replicas),
            "window": self.window,
            "canary_n": can.n, "baseline_n": base.n,
            "ttft_p99_canary": can.ttft_p99(),
            "ttft_p99_baseline": base.ttft_p99(),
            "intertoken_p99_canary": can.intertoken_p99(),
            "intertoken_p99_baseline": base.intertoken_p99(),
            "goodput_ratio_canary": round(can.goodput_ratio(), 4),
            "goodput_ratio_baseline": round(base.goodput_ratio(), 4),
            "ttft_x": self.ttft_x,
            "min_delta_s": self.min_delta_s,
            "goodput_drop": self.goodput_drop,
            "elapsed_s": round(self._clock() - self._began_ts, 3),
        }
        breaches = slo_breaches(can, base, self.ttft_x,
                                self.min_delta_s, self.goodput_drop)
        if breaches:
            self._rollback(breaches, evidence)
        else:
            self._promote(evidence)

    def _promote(self, evidence):
        self.state = "promoted"
        self._stats = None
        self._m_fraction.set(100)
        self.decisions.append(("promote", evidence))
        self._metrics.event("route_promote", **evidence)

    def _rollback(self, breaches, evidence):
        self.state = "rolled_back"
        self.quarantined.add(self.canary_generation)
        self._stats = None
        self._m_fraction.set(0)
        self._m_state.set(-1)
        evidence = dict(evidence, breaches=breaches)
        self.decisions.append(("rollback", evidence))
        self._metrics.event("route_rollback", **evidence)
