"""Launch settings and a deadline helper: the port's copy of
``horovod_tpu/run/settings.py`` (reference
horovod/run/common/util/settings.py, timeout.py)."""

import time
from dataclasses import dataclass, field


class TimeoutException(Exception):
    pass


class Timeout:
    """An absolute deadline with a contextual error message (reference
    timeout.py:19-45), on the monotonic clock: a wall-clock step during a
    slow launch must not expire (or extend) the registration window. The
    JAX package reads its metrics plane's shared clock here; the port has
    none yet, and keeps its own."""

    def __init__(self, timeout_s, message):
        self._deadline = time.monotonic() + timeout_s
        self._message = message

    def remaining(self):
        return max(0.0, self._deadline - time.monotonic())

    def timed_out(self):
        return time.monotonic() > self._deadline

    def check(self):
        if self.timed_out():
            raise TimeoutException(self._message)


@dataclass
class Settings:
    """Everything the launcher needs (reference settings.py:17-49)."""
    num_proc: int = 1
    hosts: list = field(default_factory=list)  # [HostSlots]
    command: list = field(default_factory=list)
    key: bytes = b""
    start_timeout_s: float = 600.0
    ssh_port: int = None
    verbose: int = 0
    env: dict = field(default_factory=dict)
