"""Host-list parsing, ssh reachability checks, host hashing: the port's
copy of ``horovod_tpu/run/hosts.py``.

Reference: ``-H host1:4,host2:4`` parsing and the threaded, cached ssh
check in horovod/run/run.py:48-103,373-402; host hash in
horovod/run/common/util/host_hash.py.
"""

import hashlib
import os
import socket
import subprocess
from dataclasses import dataclass

from .threads import execute_function_multithreaded


SSH_OPTS = ["-o", "StrictHostKeyChecking=no", "-o", "BatchMode=yes",
            "-o", "ConnectTimeout=10"]


@dataclass(frozen=True)
class HostSlots:
    hostname: str
    slots: int


def parse_hosts(hosts_str):
    """Parse ``host1:2,host2:4`` into [HostSlots] (run/run.py:346-358)."""
    out = []
    for part in hosts_str.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            host, slots = part.rsplit(":", 1)
            out.append(HostSlots(host, int(slots)))
        else:
            out.append(HostSlots(part, 1))
    if not out:
        raise ValueError(f"No hosts found in {hosts_str!r}")
    return out


def expand_slots(hosts):
    """[(rank, HostSlots, local_rank)] over all slots, rank-major by host."""
    out = []
    rank = 0
    for h in hosts:
        for local_rank in range(h.slots):
            out.append((rank, h, local_rank))
            rank += 1
    return out


def is_local(hostname):
    return hostname in ("localhost", "127.0.0.1", socket.gethostname(),
                        socket.getfqdn())


def host_hash():
    """Stable identifier for 'same physical host' grouping (reference
    host_hash.py; used to group Spark tasks by machine)."""
    basis = f"{socket.gethostname()}-{os.environ.get('HVD_HOST_SALT', '')}"
    return hashlib.md5(basis.encode()).hexdigest()


def _check_ssh(host, timeout_s):
    try:
        res = subprocess.run(["ssh"] + SSH_OPTS + [host, "true"],
                             capture_output=True, timeout=timeout_s)
        return res.returncode == 0
    except Exception:  # noqa: BLE001 — False is the signal; the caller
        return False   # reports the unreachable hosts


def check_all_hosts_ssh_successful(hostnames, timeout_s=30, fn_cache=None):
    """Threaded ssh reachability over all remote hosts (run/run.py:48-103).
    Raises on any failure. Results may be memoized via fn_cache."""
    remote = [h for h in hostnames if not is_local(h)]
    if not remote:
        return True

    def one(host):
        if fn_cache is not None:
            ok = fn_cache.get(("ssh", host))
            if ok is not None:
                return host, ok
        ok = _check_ssh(host, timeout_s)
        if fn_cache is not None and ok:
            fn_cache.put(("ssh", host), ok)
        return host, ok

    results = execute_function_multithreaded(one, [(h,) for h in remote])
    failed = [h for h, ok in results if not ok]
    if failed:
        raise RuntimeError(
            "SSH was unable to reach the following hosts: "
            f"{sorted(failed)}. Check passwordless ssh is configured.")
    return True
