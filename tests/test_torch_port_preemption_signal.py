"""The port's SIGTERM handlers take no lock.

Python runs a signal handler on the main thread between two bytecodes,
so a handler that takes a plain lock the main thread already holds waits
on itself forever. Each case runs a subprocess that installs the tracing
plane's flight-dump handler and the Checkpointer's preemption handler,
holds one of the locks the handlers used to reach on the main thread
while SIGTERM is delivered, then releases it and ends the step: the
emergency save must commit, the process must exit 45, and the flight
dump must say ``sigterm``. Every subprocess runs under a hard timeout
and is killed at it, so a handler that deadlocks fails the case and
never hangs the suite.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from horovod_tpu_torch.utils import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the whole process (interpreter, torch import, save) takes ~3 s here
HARD_TIMEOUT_S = 20

# the locks the handlers reached before the repair, as expressions of
# ``reg`` (the metrics registry) and ``tr`` (the tracer)
LOCKS = {
    "registry": "reg._lock",
    "tracer": "tr._lock",
    # the family the dump's counter lands in, before its child exists
    "family": ("reg.counter('hvd_flight_dumps_total', "
               "'Flight-recorder dumps written, by trigger.', "
               "labels=('reason',))._lock"),
}

_PREAMBLE = """
import os, signal, sys, time
import torch
from horovod_tpu_torch import trainer
from horovod_tpu_torch.utils import metrics, tracing
reg = metrics.reset(enabled=True)
tr = tracing.reset(enabled=True, rank=0)
assert tracing.install_signal_dump()
"""

_WITH_CHECKPOINTER = _PREAMBLE + """
ckpt = trainer.Checkpointer({dir!r}, every=100)
w = torch.zeros(3)
held = {lock}
with held:
    os.kill(os.getpid(), signal.SIGTERM)
    # the handler ran at the bytecode after the kill, with the lock held
    w += 1.0
    time.sleep(0.2)
print("released", flush=True)
w += 1.0
if ckpt.step_end(1, {{"w": w}}, extra={{"data_pos": 1}}):
    assert any(e["event"] == "ckpt_preempt" and e["signum"] == 15
               for e in reg.events())
    print("preempted", flush=True)
    sys.exit(trainer.PREEMPTED_EXIT_CODE)
print("not preempted", flush=True)
"""

_WITHOUT_CHECKPOINTER = _PREAMBLE + """
held = {lock}
with held:
    os.kill(os.getpid(), signal.SIGTERM)
    time.sleep(0.2)
print("released", flush=True)
time.sleep({sleep})
print("survived", flush=True)
"""


def _run(code, tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, HVD_FLIGHT_DIR=str(tmp_path),
               HVD_FLIGHT_SIGTERM="1", HVD_CKPT_PREEMPTION="1")
    try:
        return subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True,
                              timeout=HARD_TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:   # killed by subprocess.run
        pytest.fail(f"SIGTERM handler deadlocked: no exit within "
                    f"{HARD_TIMEOUT_S} s; stdout {exc.stdout!r}")


def _flight(tmp_path):
    return json.load(open(tmp_path / "flight-rank0.json"))


@pytest.mark.parametrize("checkpointer", [True, False],
                         ids=["checkpointer", "dump-only"])
@pytest.mark.parametrize("lock", sorted(LOCKS))
def test_sigterm_under_held_lock(tmp_path, lock, checkpointer):
    if checkpointer:
        directory = str(tmp_path / "ckpt")
        run = _run(_WITH_CHECKPOINTER.format(dir=directory,
                                             lock=LOCKS[lock]), tmp_path)
        assert run.returncode == 45, (run.stdout, run.stderr)
        assert "released" in run.stdout and "preempted" in run.stdout
        tree, step, extra = checkpoint.restore_with_extra(
            directory, like={"w": torch.zeros(3)})
        assert step == 1 and extra == {"data_pos": 1}
        np.testing.assert_array_equal(tree["w"].numpy(), np.full(3, 2.0))
    else:
        run = _run(_WITHOUT_CHECKPOINTER.format(
            lock=LOCKS[lock], sleep=HARD_TIMEOUT_S), tmp_path)
        # the dump thread re-delivers under SIG_DFL once the dump is on
        # disk: the process dies by SIGTERM long before its sleep ends
        assert run.returncode == -signal.SIGTERM, (run.stdout, run.stderr)
        assert "survived" not in run.stdout
    assert _flight(tmp_path)["reason"] == "sigterm"
