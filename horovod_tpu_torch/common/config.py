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
)


@dataclasses.dataclass
class HorovodConfig:
    """Runtime knobs, parsed once at init."""

    # Tensor fusion: bytes of gradient data batched into one collective;
    # 0 or less sends every tensor alone.
    fusion_threshold: int = 64 * 1024 * 1024
    # Default wire codec of DistributedOptimizer's gradient allreduces.
    compression: str = "none"

    @classmethod
    def from_env(cls):
        return cls(
            fusion_threshold=env_int("FUSION_THRESHOLD", 64 * 1024 * 1024),
            compression=(env_str("COMPRESSION", "none") or "none")
            .strip().lower(),
        )
