"""Environment-variable configuration surface of the port.

The same ``HOROVOD_*`` names as the JAX package, each with an ``HVD_*``
alias (``horovod_tpu/common/config.py``'s helpers, copied rather than
imported so that the port never loads jax). Only the helpers travel;
the knob registry itself comes with the runtime slice of the port.
"""

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
