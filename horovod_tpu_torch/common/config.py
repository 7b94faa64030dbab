"""Environment-variable configuration surface of the port.

The same ``HOROVOD_*`` names as the JAX package, each with an ``HVD_*``
alias (``horovod_tpu/common/config.py``'s helpers, copied rather than
imported so that the port never loads jax). ``ENV_REGISTRY`` lists the
knobs the port reads so far (the eager core's from the JAX package's
rows, with the same names and defaults), in the JAX package's row format
``(name, aliased, default, owner, description)``; ``HorovodConfig``
parses them once, at ``init()``.
"""

import dataclasses
import os


def _env(name, default=None):
    """Look up HOROVOD_<name> with HVD_<name> as an alias."""
    for prefix in ("HOROVOD_", "HVD_"):
        val = os.environ.get(prefix + name)
        if val is not None:
            return val
    return default


def env_bool(name, default=False):
    val = _env(name)
    if val is None:
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")


def env_int(name, default):
    val = _env(name)
    if val is None:
        return default
    try:
        return int(val)
    except ValueError:
        return default


def env_float(name, default):
    val = _env(name)
    if val is None:
        return default
    try:
        return float(val)
    except ValueError:
        return default


def env_str(name, default=None):
    return _env(name, default)


ENV_REGISTRY = (
    ("HOROVOD_AUTOTUNE", True, "0", "common/config.py",
     "Enable the online fusion-parameter autotuner."),
    ("HOROVOD_AUTOTUNE_LOG", True, None, "common/config.py",
     "CSV file the autotuner appends sampled points to."),
    ("HOROVOD_AUTOTUNE_SYNC_COLLECTIVES", True, "32", "common/config.py",
     "Adopt tuned values every N replicated collectives (keeps ranks "
     "in lockstep)."),
    ("HOROVOD_ALERT", True, "1", "utils/alerts.py",
     "Set 0 to replace the AlertManager with a no-op (no rule "
     "evaluation, no incidents; the hvd_alert_state gauges never "
     "appear)."),
    ("HOROVOD_ALERT_FOR_S", True, "5.0", "utils/alerts.py",
     "Default breach hold before an alert rule fires (and clear hold "
     "before it resolves)."),
    ("HOROVOD_ALERT_INTERVAL_S", True, "1.0", "utils/alerts.py",
     "Least seconds between alert-rule evaluations."),
    ("HOROVOD_CACHE_CAPACITY", True, "1024", "common/config.py",
     "Response-cache capacity of the negotiation client."),
    ("HOROVOD_CHAOS_DELAY_MS", True, "50.0", "run/chaos.py",
     "Injected delay for chaos delay_request/delay_response rules."),
    ("HOROVOD_CHAOS_SEED", True, "0", "run/chaos.py",
     "Deterministic seed for chaos-rule sampling."),
    ("HOROVOD_CHAOS_SPEC", True, None, "run/chaos.py",
     "Chaos-plane fault spec (run/chaos.py grammar); unset disables "
     "injection."),
    ("HOROVOD_COMPRESSION", True, "none", "common/config.py",
     "Wire codec for gradient allreduces: none, fp16, bf16, or the "
     "block-scaled int8/fp8 (two-phase encoded allreduce with error "
     "feedback on the eager core)."),
    ("HOROVOD_COORDINATOR_LOST_TIMEOUT_SECONDS", True, "0.0",
     "common/config.py",
     "Worker self-terminates after this long without coordinator "
     "contact (0: the eager core's built-in 5 s)."),
    ("HOROVOD_CYCLE_TIME", True, "5.0", "common/config.py",
     "Negotiation cycle time in milliseconds."),
    ("HOROVOD_ELASTIC_BREAKER_CLOSE_N", True, "3", "router/elastic.py",
     "Circuit breaker: consecutive successful completions a half-open "
     "replica must serve before its breaker closes again."),
    ("HOROVOD_ELASTIC_BREAKER_FAILS", True, "3", "router/elastic.py",
     "Circuit breaker: consecutive failed dispatches that trip a "
     "replica's breaker open (probe traffic only until it recovers)."),
    ("HOROVOD_ELASTIC_BREAKER_TIMEOUT_S", True, "10.0", "router/elastic.py",
     "Circuit breaker: a live replica holding a dispatched request "
     "longer than this without completing is declared wedged and its "
     "breaker trips — catches the heartbeating-but-stuck failure the "
     "liveness ledger cannot see."),
    ("HOROVOD_ELASTIC_COOLDOWN_S", True, "10.0", "router/elastic.py",
     "Elasticity: minimum seconds between executed scale changes; "
     "with the dwell requirement this is the anti-flap hysteresis."),
    ("HOROVOD_ELASTIC_DOWN_UTIL", True, "0.25", "router/elastic.py",
     "Elasticity: scale down when fleet slot utilization stays at or "
     "below this fraction (and the queue is empty) for the dwell "
     "window."),
    ("HOROVOD_ELASTIC_DRAIN_TIMEOUT_S", True, "30.0", "router/core.py",
     "Graceful drain: seconds a DRAINING replica gets to finish its "
     "in-flight work before the router force-retires it and reroutes "
     "the remainder through the exactly-once ledger."),
    ("HOROVOD_ELASTIC_DWELL_S", True, "5.0", "router/elastic.py",
     "Elasticity: a pressure or idle signal must hold continuously "
     "this long before a scale decision executes (one blip never "
     "moves the fleet)."),
    ("HOROVOD_ELASTIC_MAX_REPLICAS", True, "0", "router/elastic.py",
     "Elasticity: ceiling on live replicas for scale-up (0 = "
     "unbounded)."),
    ("HOROVOD_ELASTIC_MIN_REPLICAS", True, "1", "router/elastic.py",
     "Elasticity: floor on live replicas — scale-down never drains "
     "below it."),
    ("HOROVOD_ELASTIC_PROBE_S", True, "2.0", "router/elastic.py",
     "Circuit breaker: seconds between single probe requests admitted "
     "to an open replica to test recovery."),
    ("HOROVOD_ELASTIC_SHED_DEPTH", True, "16", "router/core.py",
     "Overload shedding: Router.submit rejects at admission (with a "
     "retry-after derived from the drain rate) when every usable "
     "replica's queue depth reaches this, or all are KV-exhausted (0 "
     "disables shedding)."),
    ("HOROVOD_ELASTIC_TTFT_SLO_S", True, "1.0", "router/elastic.py",
     "Elasticity: rolling-window p99 TTFT above this is scale-up "
     "pressure even when queues look shallow."),
    ("HOROVOD_ELASTIC_UP_DEPTH", True, "4.0", "router/elastic.py",
     "Elasticity: mean queue depth per live replica at or above this "
     "is scale-up pressure."),
    ("HOROVOD_FLEET_POLL_S", True, "0.5", "fleet/subscriber.py",
     "Fleet plane: seconds between publication-pointer polls by a "
     "serving replica's WeightSubscriber (the fast path is one stat)."),
    ("HOROVOD_FLEET_PUBLISH", True, "0", "trainer.py",
     "Fleet plane: publish every committed checkpoint as a weight "
     "generation (trainer.Checkpointer attaches a WeightPublisher on "
     "rank 0)."),
    ("HOROVOD_FLEET_VERIFY", True, "1", "fleet/subscriber.py",
     "Fleet plane: checksum-verify a published generation's files "
     "before arming it for a hot swap (0 trusts the manifest; corrupt "
     "weights would reach decode)."),
    ("HOROVOD_FLIGHT_CYCLES", True, "64", "utils/tracing.py",
     "Flight-recorder ring size for negotiation-cycle records."),
    ("HOROVOD_FLIGHT_DIR", True, None, "utils/tracing.py",
     "Directory flight-recorder dumps are written to (default: "
     "<tmp>/hvd-flight)."),
    ("HOROVOD_FLIGHT_SIGTERM", True, "1", "utils/tracing.py",
     "Set 0 to skip installing the SIGTERM flight-dump handler."),
    ("HOROVOD_FLIGHT_SPANS", True, "2048", "utils/tracing.py",
     "Flight-recorder ring size for finished spans."),
    ("HOROVOD_FUSION_THRESHOLD", True, "67108864", "common/config.py",
     "Fusion-buffer byte threshold for bucketing collectives."),
    ("HOROVOD_HIERARCHICAL_ALLREDUCE", True, "0", "ops/operation_manager.py",
     "Two-level allreduce (reduce-scatter over 'chips', allreduce over "
     "'slices', all-gather over 'chips') for reductions spanning both "
     "hierarchy axes."),
    ("HOROVOD_HIERARCHICAL_ALLGATHER", True, "0", "common/config.py",
     "Two-level allgather (parsed; no port path reads it yet)."),
    ("HOROVOD_HISTORY", True, "1", "utils/history.py",
     "Set 0 to disable the durable run-history WAL (per-rank "
     "delta-encoded metrics snapshots + the event ring, written by a "
     "background thread)."),
    ("HOROVOD_HISTORY_DIR", True, None, "utils/history.py",
     "Directory history segments and the rank-0 run manifest are "
     "written to (default: <tmp>/hvd-history)."),
    ("HOROVOD_HISTORY_INTERVAL_S", True, "30.0", "utils/history.py",
     "Seconds between history snapshots; pokes inside the interval "
     "are a lock-free no-op on the instrument path."),
    ("HOROVOD_HISTORY_MAX_MB", True, "64.0", "utils/history.py",
     "On-disk budget per rank for history segments."),
    ("HOROVOD_LOG_LEVEL", True, "WARNING", "common/config.py",
     "Framework log level (TRACE/DEBUG/INFO/WARNING/ERROR/FATAL)."),
    ("HOROVOD_LOG_TIMESTAMP", True, "0", "common/config.py",
     "Prefix log lines with timestamps."),
    ("HOROVOD_MEM", True, "1", "utils/memory.py",
     "Set 0 to disable the memory & compile observability plane (HBM "
     "ledger gauges, compile-site tracking, recompile-storm ladder, "
     "resharding sentinel reporting)."),
    ("HOROVOD_MEM_STORM_DECAY", True, "0.8", "utils/memory.py",
     "EMA decay of the per-site compile-miss rate the recompile-storm "
     "detector maintains (closer to 1 = longer memory)."),
    ("HOROVOD_MEM_STORM_EMA", True, "0.5", "utils/memory.py",
     "Miss-rate EMA threshold above which an instrumented compile site "
     "is declared in a recompile storm."),
    ("HOROVOD_MEM_STORM_MIN", True, "3", "utils/memory.py",
     "Minimum distinct compile misses at a site before the storm "
     "ladder may fire (the first compile is always free)."),
    ("HOROVOD_METRICS", True, "1", "utils/metrics.py",
     "Set 0 to replace the metrics registry with no-op instruments."),
    ("HOROVOD_METRICS_EVENT_LOG", True, None, "utils/metrics.py",
     "JSONL file the metrics event channel appends to."),
    ("HOROVOD_METRICS_INTERVAL", True, "5.0", "common/config.py",
     "Seconds between a worker's piggybacked metrics snapshots to "
     "rank 0."),
    ("HOROVOD_METRICS_PORT", True, "0", "common/config.py",
     "Base HTTP port of /metrics and /metrics.json: rank r binds it + "
     "r, rank 0 also serving the aggregate (0 disables)."),
    ("HOROVOD_NUMERICS", True, "1", "utils/numerics.py",
     "Set 0 to replace the numerics plane (gradient health stats + "
     "divergence sentinel) with no-ops."),
    ("HOROVOD_NUMERICS_DIGEST_CYCLES", True, "32", "utils/numerics.py",
     "How many recent cycles the coordinator retains cross-rank "
     "digests for."),
    ("HOROVOD_NUMERICS_EMA_BETA", True, "0.9", "utils/numerics.py",
     "Decay of the per-tensor gradient-norm EMA the spike policy "
     "compares against."),
    ("HOROVOD_NUMERICS_EMA_K", True, "8.0", "utils/numerics.py",
     "Flag a norm_spike anomaly when a gradient norm exceeds k times "
     "its EMA."),
    ("HOROVOD_NUMERICS_TOLERANCE", True, "1e-4", "utils/numerics.py",
     "Relative cross-rank disagreement tolerance for post-allreduce "
     "digest records."),
    ("HOROVOD_NUMERICS_WARMUP", True, "5", "utils/numerics.py",
     "Per-tensor observations before the norm-spike policy arms."),
    ("HOROVOD_OVERLAP_EAGER", True, "0", "optim.py",
     "Overlap plane: allreduce_gradients and the eager step enqueue in "
     "reverse order and drain every filled fusion bucket while later "
     "tensors are still being enqueued (EagerCoordinator.flush_ready)."),
    ("HOROVOD_OVERLAP_HIERARCHICAL", True, "0", "ops/eager.py",
     "The eager core's allreduces take the two-level engine "
     "(reduce-scatter within a host, allreduce across hosts, all-gather "
     "within a host; a quantized codec on the inter-host leg only)."),
    ("HOROVOD_OVERLAP_LOCAL_SIZE", True, "0", "ops/eager.py",
     "Processes per host of the two-level split (0: the launcher's "
     "HVD_LOCAL_SIZE); must divide the world size."),
    ("HOROVOD_PERF_ATTRIB_EVERY", True, "0", "trainer.py",
     "Capture + attribute every Nth instrumented step (torch.profiler "
     "trace -> per-class hvd_step_breakdown_ms / overlap gauges); 0 "
     "(the default) keeps the capture off the hot path."),
    ("HOROVOD_QUANT_BLOCK", True, "256", "common/config.py",
     "Elements per block-scaled quantization block (one f32 scale "
     "each)."),
    ("HOROVOD_QUANT_EF", True, "1", "common/config.py",
     "Error feedback for quantized codecs: carry encode rounding "
     "error into the next step (set 0 to disable)."),
    ("HOROVOD_QUANT_MIN_BYTES", True, "1024", "common/config.py",
     "Tensors smaller than this many bytes skip the quantized wire "
     "and stay full width."),
    ("HOROVOD_RANK_LOST_TIMEOUT_SECONDS", True, "0.0",
     "common/config.py",
     "Coordinator declares a silent rank lost after this long "
     "(0 disables)."),
    ("HOROVOD_RING_ALLREDUCE", True, "0", "ops/operation_manager.py",
     "The explicit ring allreduce (N-1 neighbour exchanges of "
     "reduce-scatter, then of all-gather) over one axis."),
    ("HOROVOD_ROUTE_AFFINITY_PREFIX", True, "8", "router/core.py",
     "Router plane: prompt-prefix length (tokens) hashed for "
     "cache-affinity stickiness; 0 disables affinity routing."),
    ("HOROVOD_ROUTE_CANARY_GOODPUT_DROP", True, "0.10", "router/canary.py",
     "Canary rollout: roll back when the canary cohort's goodput "
     "ratio (completed tokens / all tokens) falls more than this "
     "below the baseline cohort's."),
    ("HOROVOD_ROUTE_CANARY_MIN_DELTA_S", True, "0.025", "router/canary.py",
     "Canary rollout: a latency breach additionally needs this "
     "absolute p99 gap (seconds) — keeps the verdict above the "
     "histogram buckets' own resolution."),
    ("HOROVOD_ROUTE_CANARY_PCT", True, "10.0", "router/canary.py",
     "Canary rollout: percent of traffic (deterministic request-id "
     "hash) steered to the cohort serving the newly armed weight "
     "generation."),
    ("HOROVOD_ROUTE_CANARY_REPLICAS", True, "1", "router/canary.py",
     "Canary rollout: max replicas admitted to the canary cohort when "
     "several arm the new generation at once; the rest hold as "
     "baseline."),
    ("HOROVOD_ROUTE_CANARY_TTFT_X", True, "1.5", "router/canary.py",
     "Canary rollout: roll back when the canary cohort's p99 TTFT or "
     "inter-token gap exceeds this multiple of the baseline cohort's."),
    ("HOROVOD_ROUTE_CANARY_WINDOW", True, "24", "router/canary.py",
     "Canary rollout: completed requests each cohort must accumulate "
     "before the promote/rollback verdict is computed."),
    ("HOROVOD_ROUTE_POLICY", True, "least_loaded", "router/policy.py",
     "Router plane: dispatch policy over live replica load snapshots "
     "(least_loaded, round_robin)."),
    ("HOROVOD_ROUTE_REROUTE_WINDOW_S", True, "30.0", "router/core.py",
     "Router plane: max age (seconds since dispatch) a request may be "
     "requeued to a survivor after its replica is lost; older "
     "requests fail loudly instead of resurrecting."),
    ("HOROVOD_ROUTE_STALE_S", True, "5.0", "router/core.py",
     "Router plane: exclude a replica from dispatch once its load "
     "snapshot is older than this — a silent replica ages out instead "
     "of scoring as freshly idle forever (0 disables; never-reported "
     "replicas get this long as a post-add grace window)."),
    ("HOROVOD_SERVE_TRACE", True, "1", "serving/tracing.py",
     "Set 0 to disable request-path tracing (per-request spans and "
     "phase decomposition) in the serving plane."),
    ("HOROVOD_SERVE_TRACE_SLOW_TICK_MS", True, "250.0",
     "serving/tracing.py",
     "Decode ticks slower than this emit a slow_decode_tick event "
     "into the metrics ring."),
    ("HOROVOD_STALL_CHECK_DISABLE", True, "0", "common/config.py",
     "Disable the coordinator's stalled-rank warnings."),
    ("HOROVOD_STALL_CHECK_TIME_SECONDS", True, "60.0",
     "common/config.py",
     "Warn when an entry waits longer than this for stragglers."),
    ("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", True, "0.0",
     "common/config.py",
     "Escalate a stall to job shutdown after this long (0 disables)."),
    ("HOROVOD_TIMELINE", True, None, "common/config.py",
     "Write a Chrome-trace timeline to this file."),
    ("HOROVOD_TIMELINE_MARK_CYCLES", True, "0", "common/config.py",
     "Mark negotiation cycles in the timeline."),
    ("HOROVOD_TRACE", True, "1", "utils/tracing.py",
     "Set 0 to replace the tracing plane (spans + flight recorder) "
     "with no-ops."),
    ("HOROVOD_TRACE_SLOW_MS", True, "100.0", "utils/tracing.py",
     "Spans slower than this emit a slow_span event into the metrics "
     "ring."),
)


@dataclasses.dataclass
class HorovodConfig:
    """Runtime knobs, parsed once at init."""

    # Tensor fusion: bytes of gradient data batched into one collective;
    # 0 or less sends every tensor alone.
    fusion_threshold: int = 64 * 1024 * 1024
    # Eager coordination cycle time in ms (pacing of the flush loop).
    cycle_time_ms: float = 5.0
    # Response/plan cache capacity (entries).
    cache_capacity: int = 1024
    # Timeline tracing output path (rank-0 only), empty disables.
    timeline_filename: str = ""
    timeline_mark_cycles: bool = False
    # Stall detection.
    stall_check_disable: bool = False
    stall_warning_time_seconds: float = 60.0
    stall_shutdown_time_seconds: float = 0.0  # 0 = never hard-shutdown
    # Liveness: the coordinator declares a rank LOST (fail-fast
    # RanksLostError to every surviving rank) when it has heartbeated at
    # least once and then gone silent for this long. 0 disables the
    # escalation.
    rank_lost_timeout_seconds: float = 0.0
    # Worker-side mirror: how long the coordinator must stay unreachable
    # before a worker fails its pending work. 0 = the eager core's
    # built-in default (EagerCoordinator.POISON_GRACE_S).
    coordinator_lost_timeout_seconds: float = 0.0
    # Telemetry plane (utils/metrics.py): base port of the per-rank
    # exposition server (rank r binds metrics_port + r; 0 disables) and
    # the seconds between a worker's piggybacked snapshots to rank 0.
    metrics_port: int = 0
    metrics_interval: float = 5.0
    # Online autotuning of fusion_threshold / cycle_time_ms
    # (utils/autotune.py): rank 0 tunes, every rank adopts at the same
    # agreed point; autotune_log is the CSV of scored points, and without
    # a coordinator the ranks adopt every autotune_sync_collectives
    # collectives.
    autotune: bool = False
    autotune_log: str = ""
    autotune_sync_collectives: int = 32
    # Wire codec of the eager core's allreduces (and the default of
    # DistributedOptimizer's): "none" keeps full width, "fp16"/"bf16"
    # cast, "int8"/"fp8" are block-scaled with one f32 max-abs scale per
    # block (ops/quantization.py). Selection is per tensor (floating,
    # at least quant_min_bytes) and, under negotiation, rank 0's, with a
    # fingerprint check that fails loudly if any rank's knobs differ.
    compression: str = "none"
    # Elements per quantization block (the scale overhead is
    # 4/quant_block bytes per element).
    quant_block: int = 256
    # Tensors smaller than this stay full width.
    quant_min_bytes: int = 1024
    # Error feedback: carry each encode's rounding error into the next
    # step's buffer.
    quant_ef: bool = True
    # Hierarchical (two-level 'chips' / 'slices') collectives.
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    # The explicit ring allreduce backend (ops/operation_manager.py).
    ring_allreduce: bool = False
    # Overlap plane: dispatch fused gradient buckets in readiness order
    # while later tensors are still being enqueued, instead of one
    # barrier-then-allreduce over the whole set. Off by default: the
    # barrier path stays the reference behavior.
    overlap_eager: bool = False
    # The eager core's two-level reduction: a full-width reduce-scatter
    # within a host, an allreduce across hosts on the negotiated codec,
    # an all-gather within a host.
    overlap_hierarchical: bool = False
    # Processes per host for the two-level split; 0 takes the
    # launcher's HVD_LOCAL_SIZE. Must divide the world size; a split
    # with one host falls back flat.
    overlap_local_size: int = 0
    # Logging.
    log_level: str = "WARNING"
    log_timestamp: bool = False

    @classmethod
    def from_env(cls):
        return cls(
            fusion_threshold=env_int("FUSION_THRESHOLD", 64 * 1024 * 1024),
            cycle_time_ms=env_float("CYCLE_TIME", 5.0),
            cache_capacity=env_int("CACHE_CAPACITY", 1024),
            timeline_filename=env_str("TIMELINE", "") or "",
            timeline_mark_cycles=env_bool("TIMELINE_MARK_CYCLES", False),
            stall_check_disable=env_bool("STALL_CHECK_DISABLE", False),
            stall_warning_time_seconds=env_float(
                "STALL_CHECK_TIME_SECONDS", 60.0),
            stall_shutdown_time_seconds=env_float(
                "STALL_SHUTDOWN_TIME_SECONDS", 0.0),
            rank_lost_timeout_seconds=env_float(
                "RANK_LOST_TIMEOUT_SECONDS", 0.0),
            coordinator_lost_timeout_seconds=env_float(
                "COORDINATOR_LOST_TIMEOUT_SECONDS", 0.0),
            metrics_port=env_int("METRICS_PORT", 0),
            metrics_interval=env_float("METRICS_INTERVAL", 5.0),
            autotune=env_bool("AUTOTUNE", False),
            autotune_log=env_str("AUTOTUNE_LOG", "") or "",
            autotune_sync_collectives=env_int("AUTOTUNE_SYNC_COLLECTIVES",
                                              32),
            compression=(env_str("COMPRESSION", "none") or "none")
            .strip().lower(),
            quant_block=env_int("QUANT_BLOCK", 256),
            quant_min_bytes=env_int("QUANT_MIN_BYTES", 1024),
            quant_ef=env_bool("QUANT_EF", True),
            hierarchical_allreduce=env_bool("HIERARCHICAL_ALLREDUCE", False),
            hierarchical_allgather=env_bool("HIERARCHICAL_ALLGATHER", False),
            ring_allreduce=env_bool("RING_ALLREDUCE", False),
            overlap_eager=env_bool("OVERLAP_EAGER", False),
            overlap_hierarchical=env_bool("OVERLAP_HIERARCHICAL", False),
            overlap_local_size=env_int("OVERLAP_LOCAL_SIZE", 0),
            log_level=env_str("LOG_LEVEL", "WARNING") or "WARNING",
            log_timestamp=env_bool("LOG_TIMESTAMP", False),
        )
