"""Process execution with group cleanup + env filtering: the port's copy
of ``horovod_tpu/run/exec_util.py``, forwarding the CUDA and torch
variables where the JAX package forwards its own.

Reference: horovod/run/common/util/safe_shell_exec.py (process-group kill
on parent death) and horovod/run/common/util/env.py (which env vars are
forwarded to workers).
"""

import os
import re
import shlex
import signal
import subprocess
import threading
import time

# Env vars never forwarded to workers (reference env.py IGNORE_REGEX).
_IGNORE = re.compile(r"^(BASH_FUNC|OLDPWD$|PWD$|SHLVL$|_$|LS_COLORS$)")
# Vars always forwarded when present.
_FORWARD_PREFIXES = ("HOROVOD_", "HVD_", "CUDA_", "TORCH_", "OMP_",
                     "PYTHON", "PATH", "LD_LIBRARY_PATH", "NCCL_")


def is_exportable(name):
    return not _IGNORE.match(name)


def filtered_env(extra=None):
    """Environment to hand to spawned workers."""
    env = {k: v for k, v in os.environ.items() if is_exportable(k)}
    if extra:
        env.update({k: str(v) for k, v in extra.items()})
    return env


def forwarded_env_flags(env=None, quote=False):
    """The subset of env worth forwarding over ssh, as VAR=VAL strings.
    quote=True shell-quotes each entry — required whenever the list is
    joined into an ssh command line, where the remote shell word-splits
    (multi-flag XLA_FLAGS would otherwise shatter)."""
    env = env if env is not None else os.environ
    out = []
    for k, v in env.items():
        if any(k.startswith(p) for p in _FORWARD_PREFIXES) and \
                is_exportable(k):
            out.append(shlex.quote(f"{k}={v}") if quote else f"{k}={v}")
    return out


def quote_argv(argv):
    """Shell-quote every token for transport through `ssh host <cmd>`."""
    return [shlex.quote(str(a)) for a in argv]


def safe_execute(command, env=None, stdout=None, stderr=None,
                 on_exit=None, index=None):
    """Run command in its own process group; returns the Popen. A watcher
    thread reaps it and optionally calls on_exit(index, returncode)
    (reference safe_shell_exec.py:17-144 semantics, simplified: no orphan
    monitor process — workers are killed via killpg on terminate())."""
    proc = subprocess.Popen(command, env=env, stdout=stdout, stderr=stderr,
                            start_new_session=True)

    if on_exit is not None:
        def watch():
            rc = proc.wait()
            on_exit(index, rc)
        threading.Thread(target=watch, daemon=True).start()
    return proc


def terminate_trees(procs, grace_s=1.5):
    """SIGTERM every process group at once, share ONE grace window, then
    SIGKILL survivors. The parallel form of terminate_tree for a worker
    fleet: serial per-proc graces can add up past a supervisor's own
    kill window, and some runtimes swallow SIGTERM entirely, so the
    SIGKILL pass must be reached promptly."""
    live = [p for p in procs if p is not None and p.poll() is None]
    for p in live:
        try:
            os.killpg(os.getpgid(p.pid), signal.SIGTERM)
        except Exception:  # noqa: BLE001 — already exited / reaped
            pass
    deadline = time.monotonic() + grace_s
    for p in live:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except Exception:  # noqa: BLE001 — still running
            pass
    for p in live:
        if p.poll() is None:
            try:
                os.killpg(os.getpgid(p.pid), signal.SIGKILL)
            except Exception:  # noqa: BLE001 — lost the race, fine
                pass
    for p in live:  # reap: SIGKILL is asynchronous; don't leave zombies
        try:
            p.wait(timeout=2.0)
        except Exception:  # noqa: BLE001 — truly wedged; move on
            pass


def terminate_tree(proc, grace_s=5.0):
    """SIGTERM then SIGKILL the whole process group."""
    if proc.poll() is not None:
        return
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
        proc.wait(timeout=grace_s)
    except Exception:
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        except Exception:
            pass
