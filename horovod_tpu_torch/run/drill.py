"""The preempt → resume, ranks lost → shrink → resume drill of the elastic
plane, driven from outside as a scheduler would: ``run_drill(directory,
np_=2, steps=10, every=2, preempt_after=3, kill_after=6, device="cuda",
train_args=())``.

It starts the supervisor over hvdrun over ``train_lm``'s checkpointed
loop::

    python -m horovod_tpu_torch.run.elastic -H localhost:NP \\
        --auto-shrink-on-ranks-lost --graceful-restart-on-preempt -- \\
        python -m horovod_tpu_torch.run -np {np} -H {hosts} \\
        python -m horovod_tpu_torch.train_lm --device DEV \\
        --checkpoint-dir D --checkpoint-every EVERY --steps STEPS \\
        --checkpoint-digest ...

reads the JSON events the ranks print, and:

  1. after step ``preempt_after`` sends SIGTERM to hvdrun (the job), which
     forwards it; the ranks finish the step, commit an emergency
     checkpoint and exit 45, and the supervisor restarts them on the same
     slots, which resume from it;
  2. once step ``kill_after`` is committed, SIGKILLs the last rank; the
     survivor's next collective fails, the control plane's liveness
     ledger confirms the loss, the survivor exits 44
     (``RanksLostError.EXIT_CODE``), and the supervisor shrinks by one slot
     and restarts, resuming from a checkpoint that more ranks wrote than
     restore it;
  3. waits for the run to reach ``steps``.

``kill_after=None`` leaves step 2 out.

It checks that every resume restored the digest the saving ranks printed
for that step, that ``extra`` carries the step and the data position,
and that the run ends at ``steps``, and returns a report: the events,
each restart's recovery time (from the supervisor's line about the exit
to the restarted job's first step) and the losses.
"""

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time


class DrillError(AssertionError):
    pass


def _command(np_, directory, steps, every, device, train_args):
    py = sys.executable
    return [py, "-m", "horovod_tpu_torch.run.elastic",
            "-H", f"localhost:{np_}", "--ports", "0",
            "--auto-shrink-on-ranks-lost", "--graceful-restart-on-preempt",
            "--", py, "-m", "horovod_tpu_torch.run", "-np", "{np}",
            "-H", "{hosts}", py, "-m", "horovod_tpu_torch.train_lm",
            "--device", device, "--checkpoint-dir", directory,
            "--checkpoint-every", str(every), "--steps", str(steps),
            "--checkpoint-digest"] + list(train_args)


def _committed(directory, step):
    return os.path.exists(os.path.join(directory, f"step-{step:010d}",
                                       "manifest.json"))


def run_drill(directory, np_=2, steps=10, every=2, preempt_after=3,
              kill_after=6, device="cuda", train_args=(), timeout=600.0,
              env=None, log=None):
    """Run the drill (module docstring); returns its report, raises
    DrillError when a check fails or the run outlasts ``timeout``."""
    env = dict(os.environ if env is None else env)
    lines = queue.Queue()
    proc = subprocess.Popen(
        _command(np_, directory, steps, every, device, train_args),
        stdout=subprocess.PIPE, stderr=log, text=True, env=env,
        start_new_session=True)

    def read():
        for line in proc.stdout:
            lines.put((time.monotonic(), line.rstrip("\n")))
        lines.put((time.monotonic(), None))
    threading.Thread(target=read, daemon=True).start()
    deadline = time.monotonic() + timeout
    report = {"events": [], "rto_s": [], "resumes": [], "saves": {},
              "losses": []}
    starts = {}         # rank -> start event of the current job
    spawned = set()     # every worker and hvdrun pid seen, for cleanup
    phase = "preempt"   # -> "kill" -> "finish"
    exit_seen = None
    try:
        while True:
            try:
                t, line = lines.get(timeout=max(
                    0.1, min(1.0, deadline - time.monotonic())))
            except queue.Empty:
                t, line = time.monotonic(), ""
            if time.monotonic() > deadline:
                raise DrillError(f"drill did not finish within {timeout} s "
                                 f"(phase {phase})")
            if line is None:
                break
            if phase == "kill" and report["resumes"] and \
                    _committed(directory, kill_after) and \
                    report["losses"] and report["losses"][-1][0] >= \
                    kill_after and 1 in starts:
                victim = starts[max(starts)]["pid"]
                os.kill(victim, signal.SIGKILL)
                report["events"].append({"event": "sigkill", "pid": victim,
                                         "after_step": kill_after})
                phase = "finish"
            if not line:
                continue
            if log is not None:
                print(line, file=log, flush=True)
            if line.startswith("elastic: job exited"):
                exit_seen = t
                report["events"].append({"event": "exit", "line": line})
                starts = {}
                continue
            if not line.startswith("{"):
                continue
            ev = json.loads(line)
            kind = ev.get("event")
            if kind == "start":
                starts[ev["rank"]] = ev
                spawned.update((ev["pid"], ev["ppid"]))
            elif kind == "save":
                report["saves"][ev["step"]] = ev
            elif kind == "resume":
                saved = report["saves"].get(ev["step"])
                if saved is None or saved["digest"] != ev["digest"]:
                    raise DrillError(f"resume at step {ev['step']} restored "
                                     f"digest {ev['digest']}, the saving "
                                     f"ranks printed {saved}")
                if ev["extra"].get("step") != ev["step"] or \
                        ev["extra"].get("data_pos") != ev["step"]:
                    raise DrillError(f"extra {ev['extra']} does not carry "
                                     f"step {ev['step']}")
                report["resumes"].append(ev)
            elif kind == "step":
                report["losses"].append((ev["step"], ev["loss"],
                                         ev["workers"]))
                if exit_seen is not None:
                    report["rto_s"].append(t - exit_seen)
                    exit_seen = None
                if phase == "preempt" and ev["step"] >= preempt_after \
                        and 0 in starts:
                    os.kill(starts[0]["ppid"], signal.SIGTERM)
                    report["events"].append({"event": "sigterm",
                                             "after_step": ev["step"]})
                    phase = "finish" if kill_after is None else "kill"
            elif kind == "done":
                report["done"] = ev
            report["events"].append(ev)
        rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if proc.poll() is None:
            # hvdrun and the workers run in sessions of their own
            for pid in [proc.pid] + sorted(spawned):
                try:
                    os.killpg(pid, signal.SIGKILL)
                except OSError:
                    pass   # already gone
            proc.wait()
    report["rc"] = rc
    if rc != 0:
        raise DrillError(f"supervisor exited {rc}")
    restarts = 1 if kill_after is None else 2
    if phase != "finish" or len(report["resumes"]) != restarts:
        raise DrillError(f"drill ended in phase {phase} with resumes "
                         f"{report['resumes']}")
    if report.get("done", {}).get("step") != steps:
        raise DrillError(f"final step {report.get('done')} != {steps}")
    if kill_after is not None and (
            report["resumes"][1]["workers"] != np_ - 1 or
            report["resumes"][1]["saved_layout"] != {"dp": np_}):
        raise DrillError(f"the shrink did not reshard {np_} ranks' "
                         f"checkpoint onto {np_ - 1}: "
                         f"{report['resumes'][1]}")
    return report

