"""Environment-variable configuration surface of the port.

The same ``HOROVOD_*`` names as the JAX package, each with an ``HVD_*``
alias (``horovod_tpu/common/config.py``'s helpers, copied rather than
imported so that the port never loads jax). ``ENV_REGISTRY`` lists the
knobs the port reads so far, in the JAX package's row format
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
    ("HOROVOD_COMPRESSION", True, "none", "common/config.py",
     "Wire codec for gradient allreduces: none, fp16 or bf16 (the "
     "quantized int8/fp8 codecs are not ported yet)."),
    ("HOROVOD_FUSION_THRESHOLD", True, "67108864", "common/config.py",
     "Fusion-buffer byte threshold for bucketing collectives."),
    ("HOROVOD_HIERARCHICAL_ALLREDUCE", True, "0", "ops/operation_manager.py",
     "Two-level allreduce (reduce-scatter over 'chips', allreduce over "
     "'slices', all-gather over 'chips') for reductions spanning both "
     "hierarchy axes."),
    ("HOROVOD_HIERARCHICAL_ALLGATHER", True, "0", "common/config.py",
     "Two-level allgather (parsed; no port path reads it yet)."),
    ("HOROVOD_RING_ALLREDUCE", True, "0", "ops/operation_manager.py",
     "The explicit ring allreduce (N-1 neighbour exchanges of "
     "reduce-scatter, then of all-gather) over one axis."),
)


@dataclasses.dataclass
class HorovodConfig:
    """Runtime knobs, parsed once at init."""

    # Tensor fusion: bytes of gradient data batched into one collective;
    # 0 or less sends every tensor alone.
    fusion_threshold: int = 64 * 1024 * 1024
    # Default wire codec of DistributedOptimizer's gradient allreduces.
    compression: str = "none"
    # Hierarchical (two-level 'chips' / 'slices') collectives.
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    # The explicit ring allreduce backend (ops/operation_manager.py).
    ring_allreduce: bool = False

    @classmethod
    def from_env(cls):
        return cls(
            fusion_threshold=env_int("FUSION_THRESHOLD", 64 * 1024 * 1024),
            compression=(env_str("COMPRESSION", "none") or "none")
            .strip().lower(),
            hierarchical_allreduce=env_bool("HIERARCHICAL_ALLREDUCE", False),
            hierarchical_allgather=env_bool("HIERARCHICAL_ALLGATHER", False),
            ring_allreduce=env_bool("RING_ALLREDUCE", False),
        )
