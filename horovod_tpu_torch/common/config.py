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
     "The online fusion-parameter autotuner: not ported yet (slice 8); "
     "init() raises NotImplementedError when it is set."),
    ("HOROVOD_CACHE_CAPACITY", True, "1024", "common/config.py",
     "Response-cache capacity of the negotiation client."),
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
    ("HOROVOD_FUSION_THRESHOLD", True, "67108864", "common/config.py",
     "Fusion-buffer byte threshold for bucketing collectives."),
    ("HOROVOD_HIERARCHICAL_ALLREDUCE", True, "0", "ops/operation_manager.py",
     "Two-level allreduce (reduce-scatter over 'chips', allreduce over "
     "'slices', all-gather over 'chips') for reductions spanning both "
     "hierarchy axes."),
    ("HOROVOD_HIERARCHICAL_ALLGATHER", True, "0", "common/config.py",
     "Two-level allgather (parsed; no port path reads it yet)."),
    ("HOROVOD_LOG_LEVEL", True, "WARNING", "common/config.py",
     "Framework log level (TRACE/DEBUG/INFO/WARNING/ERROR/FATAL)."),
    ("HOROVOD_LOG_TIMESTAMP", True, "0", "common/config.py",
     "Prefix log lines with timestamps."),
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
    # The autotuner of fusion_threshold / cycle_time_ms (not ported yet).
    autotune: bool = False
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
            autotune=env_bool("AUTOTUNE", False),
            compression=(env_str("COMPRESSION", "none") or "none")
            .strip().lower(),
            quant_block=env_int("QUANT_BLOCK", 256),
            quant_min_bytes=env_int("QUANT_MIN_BYTES", 1024),
            quant_ef=env_bool("QUANT_EF", True),
            hierarchical_allreduce=env_bool("HIERARCHICAL_ALLREDUCE", False),
            hierarchical_allgather=env_bool("HIERARCHICAL_ALLGATHER", False),
            ring_allreduce=env_bool("RING_ALLREDUCE", False),
            log_level=env_str("LOG_LEVEL", "WARNING") or "WARNING",
            log_timestamp=env_bool("LOG_TIMESTAMP", False),
        )
