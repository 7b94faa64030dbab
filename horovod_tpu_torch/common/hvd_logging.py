"""Leveled logging controlled by HOROVOD_LOG_LEVEL / HOROVOD_LOG_TIMESTAMP.

The port's copy of ``horovod_tpu/common/hvd_logging.py``, on the logger
"horovod_tpu_torch".

Python bridge over the same surface as the reference's C++ stream logger
(horovod/common/logging.{h,cc}: LogMessage logging.cc:11, ParseLogLevelStr
logging.cc:55). Levels TRACE..FATAL map onto the stdlib logging module; the
native runtime extension has its own C++ logger with the same env contract.
"""

import logging
import sys

from . import config as config_mod

_LEVELS = {
    "trace": 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

logging.addLevelName(5, "TRACE")

_logger = None


def get_logger():
    global _logger
    if _logger is None:
        _logger = logging.getLogger("horovod_tpu_torch")
        level_str = (config_mod.env_str("LOG_LEVEL", "warning") or
                     "warning").lower()
        _logger.setLevel(_LEVELS.get(level_str, logging.WARNING))
        handler = logging.StreamHandler(sys.stderr)
        if config_mod.env_bool("LOG_TIMESTAMP", False):
            fmt = ("[%(asctime)s %(levelname)s horovod_tpu_torch] "
                   "%(message)s")
        else:
            fmt = "[%(levelname)s horovod_tpu_torch] %(message)s"
        handler.setFormatter(logging.Formatter(fmt))
        _logger.addHandler(handler)
        _logger.propagate = False
    return _logger


def trace(msg, *args):
    get_logger().log(5, msg, *args)


def debug(msg, *args):
    get_logger().debug(msg, *args)


def info(msg, *args):
    get_logger().info(msg, *args)


def warning(msg, *args):
    get_logger().warning(msg, *args)


def error(msg, *args):
    get_logger().error(msg, *args)
