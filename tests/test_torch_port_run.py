"""horovod_tpu_torch's launch layer (``run/``: hvdrun, the services, the
elastic supervisor and the drill) against ``horovod_tpu/run``.

Mirrors ``tests/test_run_layer.py`` (wire, services, hosts, exec_util,
cache, timeout, local launch) and ``tests/test_elastic_launch.py``
(``shrink_hosts`` against the reference's on the same inputs, the
supervisor's restarts, its listener and the preempted/ranks-lost exit
codes). hvdrun's exit policy: a forwarded SIGTERM waits for every worker
and passes 45 on; a worker killed by a signal gives the survivor time to
exit with its own code (44). Then the drill on the CPU: two gloo ranks of
``train_lm --size tiny`` under the supervisor, preempted after step 1,
resumed on the same slots, the last rank killed after step 4 and the
survivor's checkpoint resumed on one rank to step 6; the resumed run's
parameters and moments at step 4 equal an uninterrupted run's within
2e-5 of each tensor's largest magnitude. Every spawned process runs under
a timeout.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu_torch.common.exceptions import (PREEMPTED_EXIT_CODE,
                                                 RanksLostError)
from horovod_tpu_torch.run import (cache as cache_mod, exec_util, hosts,
                                   network, secret, services)
from horovod_tpu_torch.run.cli import run_command_on_hosts
from horovod_tpu_torch.run.elastic import ElasticSupervisor, shrink_hosts
from horovod_tpu_torch.run.hosts import HostSlots, parse_hosts
from horovod_tpu_torch.run.settings import (Settings, Timeout,
                                            TimeoutException)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 60


class TestWire:
    def test_roundtrip_and_tampering(self):
        import io
        key = secret.make_secret_key()
        wire = network.Wire(key)
        buf = io.BytesIO()
        wire.write({"a": [1, 2]}, buf)
        buf.seek(0)
        assert wire.read(buf) == {"a": [1, 2]}
        data = bytearray(buf.getvalue())
        data[-1] ^= 1
        with pytest.raises(Exception):
            wire.read(io.BytesIO(bytes(data)))
        buf.seek(0)
        with pytest.raises(Exception):
            network.Wire(secret.make_secret_key()).read(buf)


class TestServices:
    def test_ping_and_register(self):
        key = secret.make_secret_key()
        driver = services.LaunchDriverService(num_tasks=2, key=key)
        try:
            addrs = {"lo": [("127.0.0.1", driver.port)]}
            client = services.LaunchDriverClient(addrs, key)
            client.register_task(0, {"lo": [("127.0.0.1", 1)]}, "h0")
            client.register_task(1, {"lo": [("127.0.0.1", 2)]}, "h1")
            driver.wait_for_initial_registration(
                Timeout(5, "registration timed out"))
            assert client.all_task_addresses(1) == {"lo": [("127.0.0.1", 2)]}
            assert driver.task_host_hashes() == {0: "h0", 1: "h1"}
        finally:
            driver.shutdown()

    def test_wrong_key_cannot_connect(self):
        key = secret.make_secret_key()
        driver = services.LaunchDriverService(num_tasks=1, key=key)
        try:
            addrs = {"lo": [("127.0.0.1", driver.port)]}
            with pytest.raises(network.NoValidAddressesFound):
                services.LaunchDriverClient(addrs, secret.make_secret_key(),
                                            probe_timeout=0.5)
        finally:
            driver.shutdown()

    def test_common_interfaces_intersection(self):
        key = secret.make_secret_key()
        driver = services.LaunchDriverService(num_tasks=2, key=key)
        try:
            client = services.LaunchDriverClient(
                {"lo": [("127.0.0.1", driver.port)]}, key)
            client.register_task_to_task_addresses(
                0, {"eth0": [("10.0.0.1", 1)], "ib0": [("10.1.0.1", 1)]})
            client.register_task_to_task_addresses(
                1, {"eth0": [("10.0.0.2", 1)]})
            driver.wait_for_task_to_task_addresses(Timeout(5, "t"))
            assert driver.common_interfaces() == {"eth0"}
        finally:
            driver.shutdown()

    def test_task_service_runs_command(self, tmp_path):
        key = secret.make_secret_key()
        task = services.LaunchTaskService(0, key)
        try:
            client = services.LaunchTaskClient(
                0, {"lo": [("127.0.0.1", task.port)]}, key)
            marker = tmp_path / "ran"
            client.run_command(
                [sys.executable, "-c",
                 f"open({str(marker)!r}, 'w').write('ok')"])
            deadline = time.time() + 10
            while time.time() < deadline:
                terminated, code = client.command_exit_code()
                if terminated:
                    break
                time.sleep(0.1)
            assert terminated and code == 0
            assert marker.read_text() == "ok"
            client.shutdown_task()
            task.wait_for_shutdown()
        finally:
            task.shutdown()

    def test_task_fn_codec_round_trip(self):
        from horovod_tpu_torch.run import task_fn
        addrs = {"lo": [("127.0.0.1", 1234)]}
        assert task_fn.codec_loads(task_fn.codec_dumps(addrs)) == addrs


class TestHosts:
    def test_parse(self):
        hs = hosts.parse_hosts("a:2,b:4,c")
        assert [(h.hostname, h.slots) for h in hs] == \
            [("a", 2), ("b", 4), ("c", 1)]
        with pytest.raises(ValueError):
            hosts.parse_hosts(" , ")

    def test_expand_slots(self):
        expanded = hosts.expand_slots(hosts.parse_hosts("a:2,b:1"))
        assert [(r, h.hostname, lr) for r, h, lr in expanded] == \
            [(0, "a", 0), (1, "a", 1), (2, "b", 0)]

    def test_localhost_is_local_and_hash_stable(self):
        assert hosts.is_local("localhost") and hosts.is_local("127.0.0.1")
        assert not hosts.is_local("definitely-not-this-host.example")
        assert hosts.host_hash() == hosts.host_hash()
        assert hosts.check_all_hosts_ssh_successful(["localhost"])


class TestExecUtil:
    def test_env_filter_and_forwarding(self):
        env = exec_util.filtered_env({"HVD_PROCESS_ID": 3})
        assert env["HVD_PROCESS_ID"] == "3" and "OLDPWD" not in env
        flags = exec_util.forwarded_env_flags(
            {"HOROVOD_FUSION_THRESHOLD": "1", "HOME": "/x", "OLDPWD": "/y",
             "CUDA_VISIBLE_DEVICES": "0", "JAX_PLATFORMS": "cpu"})
        assert flags == ["HOROVOD_FUSION_THRESHOLD=1",
                         "CUDA_VISIBLE_DEVICES=0"]
        assert exec_util.quote_argv(["a b"]) == ["'a b'"]

    def test_safe_execute_and_terminate(self):
        proc = exec_util.safe_execute([sys.executable, "-c",
                                       "import time; time.sleep(60)"])
        assert proc.poll() is None
        exec_util.terminate_tree(proc, grace_s=2.0)
        assert proc.wait(timeout=5) != 0

    def test_terminate_trees_kills_sigterm_ignoring_group(self, tmp_path):
        script = tmp_path / "stubborn.py"
        script.write_text(
            "import signal, time\n"
            "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
            "print('ready', flush=True)\n"
            "time.sleep(60)\n")
        procs = [exec_util.safe_execute(
            [sys.executable, str(script)], stdout=subprocess.PIPE)
            for _ in range(2)]
        for p in procs:
            assert p.stdout.readline().strip() == b"ready"
        t0 = time.monotonic()
        exec_util.terminate_trees(procs, grace_s=0.5)
        for p in procs:
            assert p.poll() is not None, "stubborn worker survived"
        assert time.monotonic() - t0 < 5.0


class TestCacheAndTimeout:
    def test_cache_roundtrip_and_ttl(self, tmp_path):
        c = cache_mod.Cache(cache_dir=str(tmp_path), ttl_s=1000)
        assert c.get(("ssh", "h")) is None
        c.put(("ssh", "h"), True)
        assert c.get(("ssh", "h")) is True
        assert cache_mod.Cache(cache_dir=str(tmp_path),
                               ttl_s=1000).get(("ssh", "h")) is True
        assert cache_mod.Cache(cache_dir=str(tmp_path),
                               ttl_s=0).get(("ssh", "h")) is None

    def test_timeout(self):
        t = Timeout(0.0, "boom")
        time.sleep(0.01)
        assert t.timed_out() and t.remaining() == 0.0
        with pytest.raises(TimeoutException, match="boom"):
            t.check()
        assert Timeout(10, "x").remaining() > 9


class TestLocalLaunch:
    def test_two_local_workers_env(self, tmp_path):
        script = tmp_path / "worker.py"
        script.write_text(
            "import os\n"
            "out = os.path.join(os.environ['OUT'], "
            "'r' + os.environ['HVD_PROCESS_ID'])\n"
            "open(out, 'w').write('|'.join([\n"
            "    os.environ['HVD_NUM_PROC'], os.environ['HVD_LOCAL_RANK'],\n"
            "    os.environ['HVD_LOCAL_SIZE'],\n"
            "    os.environ['HVD_COORDINATOR_ADDR']]))\n")
        rc = run_command_on_hosts(
            hosts.parse_hosts("localhost:2"), [sys.executable, str(script)],
            "127.0.0.1:12345", Settings(), extra_env={"OUT": str(tmp_path)})
        assert rc == 0
        assert (tmp_path / "r0").read_text() == "2|0|2|127.0.0.1:12345"
        assert (tmp_path / "r1").read_text() == "2|1|2|127.0.0.1:12345"

    def test_failure_propagates(self):
        rc = run_command_on_hosts(
            hosts.parse_hosts("localhost:2"),
            [sys.executable, "-c", "import sys; sys.exit(7)"],
            "127.0.0.1:1", Settings())
        assert rc == 7

    def test_one_failure_stops_the_others(self):
        code = ("import os, sys, time\n"
                "if os.environ['HVD_PROCESS_ID'] == '1': sys.exit(3)\n"
                "time.sleep(60)\n")
        t0 = time.monotonic()
        rc = run_command_on_hosts(hosts.parse_hosts("localhost:2"),
                                  [sys.executable, "-c", code],
                                  "127.0.0.1:1", Settings())
        assert rc == 3 and time.monotonic() - t0 < 20

    def test_forwarded_sigterm_waits_and_passes_45_on(self, tmp_path):
        """Each worker takes the SIGTERM, finishes what it does (rank 1
        later than rank 0) and exits 45; hvdrun waits for both."""
        code = ("import os, signal, sys, time\n"
                "done = []\n"
                "signal.signal(signal.SIGTERM, lambda *a: done.append(1))\n"
                "open(os.path.join(os.environ['OUT'], 'up' +\n"
                "     os.environ['HVD_PROCESS_ID']), 'w').close()\n"
                "while not done: time.sleep(0.05)\n"
                "time.sleep(0.5 + int(os.environ['HVD_PROCESS_ID']))\n"
                "open(os.path.join(os.environ['OUT'], 'saved' +\n"
                "     os.environ['HVD_PROCESS_ID']), 'w').close()\n"
                "sys.exit(45)\n")
        jobs = []

        def term_when_up():
            while not all((tmp_path / f"up{r}").exists() for r in range(2)):
                time.sleep(0.05)
            jobs[0].forward_term()
        threading.Thread(target=term_when_up, daemon=True).start()
        rc = run_command_on_hosts(
            hosts.parse_hosts("localhost:2"), [sys.executable, "-c", code],
            "127.0.0.1:1", Settings(), extra_env={"OUT": str(tmp_path)},
            on_spawn=jobs.append, term_grace=TIMEOUT_S)
        assert rc == PREEMPTED_EXIT_CODE
        assert (tmp_path / "saved0").exists() and \
            (tmp_path / "saved1").exists()

    def test_lost_rank_passes_the_survivors_code_on(self):
        code = ("import os, signal, sys, time\n"
                "if os.environ['HVD_PROCESS_ID'] == '1':\n"
                "    os.kill(os.getpid(), signal.SIGKILL)\n"
                "time.sleep(1.0)\n"
                "sys.exit(44)\n")
        rc = run_command_on_hosts(hosts.parse_hosts("localhost:2"),
                                  [sys.executable, "-c", code],
                                  "127.0.0.1:1", Settings(),
                                  lost_grace=TIMEOUT_S)
        assert rc == RanksLostError.EXIT_CODE

    def test_hvdrun_cli_module_exports_the_secret(self, tmp_path):
        out = tmp_path / "env.json"
        res = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "1",
             "--output-filename", str(tmp_path / "logs"), sys.executable,
             "-c", "import json, os; json.dump({k: os.environ.get(k) for k"
             " in ('HVD_SECRET_KEY', '_HVD_SECRET_KEY', 'HVD_NUM_PROC')}, "
             f"open({str(out)!r}, 'w'))"],
            capture_output=True, text=True, timeout=TIMEOUT_S, cwd=ROOT)
        assert res.returncode == 0, res.stderr
        env = json.loads(out.read_text())
        assert env["HVD_NUM_PROC"] == "1"
        assert env["HVD_SECRET_KEY"] == env["_HVD_SECRET_KEY"]
        assert len(__import__("base64").b64decode(env["HVD_SECRET_KEY"])) \
            == secret.SECRET_LENGTH
        assert (tmp_path / "logs" / "rank.0.err").exists()


# ---------------------------------------------------------------------------
# the elastic supervisor


_SHRINK_CASES = [("a:4,b:4", 4, 8), ("a:4,b:4", 3, 8), ("a:2,b:2", 2, 4),
                 ("a:2", 1, 2), ("a:3,b:3,c:2", 2, 8), ("a:2", 2, 2),
                 ("a:1,b:1,c:1,d:1", 1, 4)]


@pytest.mark.parametrize("spec,remove,total", _SHRINK_CASES)
def test_shrink_hosts_matches_the_reference(spec, remove, total):
    from horovod_tpu.run import elastic as jelastic
    try:
        want = jelastic.shrink_hosts(jelastic.parse_hosts(spec), remove,
                                     total)
    except ValueError:
        with pytest.raises(ValueError):
            shrink_hosts(parse_hosts(spec), remove, total)
        return
    new, n = shrink_hosts(parse_hosts(spec), remove, total)
    assert n == want[1]
    assert [(h.hostname, h.slots) for h in new] == \
        [(h.hostname, h.slots) for h in want[0]]


def test_shrink_examples():
    new, total = shrink_hosts(parse_hosts("a:4,b:4"), 3, 8)
    assert total == 4 and sum(h.slots for h in new) == 4
    assert shrink_hosts(parse_hosts("a:2,b:2"), 2, 4)[0] == \
        [HostSlots("a", 2)]


class _ExitedProc:
    pid = 4242

    def __init__(self, rc):
        self._rc = rc

    def wait(self, timeout=None):
        return self._rc

    def poll(self):
        return self._rc


class TestElasticSupervisor:
    def test_restart_on_slot_removal(self, tmp_path):
        log = tmp_path / "runs.log"
        script = tmp_path / "job.py"
        script.write_text(
            "import sys, time\n"
            "open(sys.argv[1], 'a').write(sys.argv[2] + '\\n')\n"
            "time.sleep(60)\n")
        sup = ElasticSupervisor(
            "localhost:4",
            [sys.executable, str(script), str(log), "np={np},bpa={bpa}"],
            ports=(0,), verbose=0)
        sup.start()
        try:
            deadline = time.time() + 10
            while time.time() < deadline and not log.exists():
                time.sleep(0.1)
            assert log.read_text() == "np=4,bpa=1\n"
            for junk in (b"not a number", b"", b"2.5"):
                with socket.create_connection(("127.0.0.1",
                                               sup.port)) as s:
                    s.sendall(junk)
            with socket.create_connection(("127.0.0.1", sup.port)) as s:
                s.sendall(b" ")
                time.sleep(0.1)
                s.sendall(b"2\n")
            deadline = time.time() + 10
            while time.time() < deadline and \
                    log.read_text().count("\n") < 2:
                time.sleep(0.1)
            assert log.read_text() == "np=4,bpa=1\nnp=2,bpa=2\n"
            assert sup.restarts == 1 and sup._exit_code == 0
        finally:
            sup.shutdown()

    def test_wait_returns_job_exit_code(self):
        sup = ElasticSupervisor(
            "localhost:2", [sys.executable, "-c", "import sys; sys.exit(3)"],
            ports=(0,), verbose=0)
        sup.start()
        assert sup.wait(poll_s=0.1) == 3

    def test_recv_message_reassembles_and_bounds(self):
        a, b = socket.socketpair()
        try:
            out = {}
            t = threading.Thread(target=lambda: out.update(
                msg=ElasticSupervisor._recv_message(a)))
            t.start()
            b.sendall(b"1")
            time.sleep(0.1)
            b.sendall(b"2\n")
            b.close()
            t.join(timeout=5)
            assert out["msg"] == b"12"
        finally:
            a.close()
        a, b = socket.socketpair()
        try:
            b.sendall(b"9" * 200)
            b.close()
            with pytest.raises(ValueError, match="exceeds"):
                ElasticSupervisor._recv_message(a)
        finally:
            a.close()

    def test_graceful_restart_on_preempted_exit(self):
        codes = [PREEMPTED_EXIT_CODE, PREEMPTED_EXIT_CODE, 0]
        calls = []

        def runner(argv):
            calls.append(list(argv))
            return _ExitedProc(codes.pop(0))
        sup = ElasticSupervisor(
            "a:2,b:2", ["job", "{np}", "{bpa}", "{restart}"], ports=(0,),
            verbose=0, runner=runner,
            graceful_restart_rc=PREEMPTED_EXIT_CODE)
        try:
            sup.start()
            assert sup.wait(poll_s=0.01) == 0
        finally:
            sup.shutdown()
        assert sup.restarts == 2 and sup.current_total == 4
        assert [c[1] for c in calls] == ["4", "4", "4"]
        assert [c[3] for c in calls] == ["0", "1", "2"]

    def test_auto_shrink_on_ranks_lost_and_max_restarts(self):
        codes = [RanksLostError.EXIT_CODE, 0]
        calls = []

        def runner(argv):
            calls.append(list(argv))
            return _ExitedProc(codes.pop(0))
        sup = ElasticSupervisor(
            "localhost:2", ["job", "{np}", "{hosts}", "{bpa}"], ports=(0,),
            verbose=0, runner=runner, auto_shrink_rc=RanksLostError.EXIT_CODE)
        try:
            sup.start()
            assert sup.wait(poll_s=0.01) == 0
        finally:
            sup.shutdown()
        assert calls == [["job", "2", "localhost:2", "1"],
                         ["job", "1", "localhost:1", "2"]]
        sup = ElasticSupervisor(
            "a:2", ["job"], ports=(0,), verbose=0,
            runner=lambda argv: _ExitedProc(PREEMPTED_EXIT_CODE),
            graceful_restart_rc=PREEMPTED_EXIT_CODE, max_restarts=3)
        try:
            sup.start()
            assert sup.wait(poll_s=0.01) == PREEMPTED_EXIT_CODE
        finally:
            sup.shutdown()
        assert sup.restarts == 3


# ---------------------------------------------------------------------------
# the drill on the CPU


TRAIN = ["--size", "tiny", "--seq-len", "32"]


def _state(directory, step):
    from horovod_tpu_torch.utils import checkpoint
    tree, got, extra = checkpoint.restore_with_extra(directory, step=step)
    assert got == step
    return tree, extra


def test_unrelated_failure_is_not_a_lost_rank(tmp_path):
    """Both ranks' steps fail with a RuntimeError that speaks of a peer
    and a socket while both live: the liveness probe finds every rank,
    so the error is raised and the job exits nonzero, not 44."""
    code = (
        "import sys\n"
        "from horovod_tpu_torch import train_lm\n"
        "draw = train_lm.batch_at\n"
        "def batch_at(seed, step, *a):\n"
        "    if step == 1:\n"
        "        raise RuntimeError('CUDA peer access: socket connection "
        "reset by peer')\n"
        "    return draw(seed, step, *a)\n"
        "train_lm.batch_at = batch_at\n"
        "train_lm.main(sys.argv[1:])\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         sys.executable, "-c", code, "--device", "cpu", "--steps", "3",
         "--checkpoint-dir", str(tmp_path / "ck")] + TRAIN,
        capture_output=True, text=True, timeout=TIMEOUT_S, env=env,
        cwd=ROOT)
    assert res.returncode not in (0, RanksLostError.EXIT_CODE), \
        res.stderr[-3000:]
    assert "CUDA peer access" in res.stderr
    assert '"event": "ranks_lost"' not in res.stdout
    # the probe answered at once: no wait for the liveness deadline
    assert time.monotonic() - t0 < 45


def test_drill_resumes_where_an_uninterrupted_run_is(tmp_path):
    """Preempt after step 1 (the emergency save lands at step 1 or 2),
    resume on 2 ranks, kill rank 1 once step 4 is committed, shrink to 1
    rank and finish step 6; the state of step 4, written after the resume,
    equals an uninterrupted 2-rank run's."""
    from horovod_tpu_torch.run import drill
    env = dict(os.environ, OMP_NUM_THREADS="1",
               HOROVOD_RANK_LOST_TIMEOUT_SECONDS="3")
    straight = str(tmp_path / "straight")
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         sys.executable, "-m", "horovod_tpu_torch.train_lm", "--device",
         "cpu", "--steps", "4", "--checkpoint-dir", straight,
         "--checkpoint-every", "2"] + TRAIN,
        capture_output=True, text=True, timeout=TIMEOUT_S, env=env,
        cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    report = drill.run_drill(
        str(tmp_path / "drill"), np_=2, steps=6, every=2, preempt_after=1,
        kill_after=4, device="cpu", train_args=TRAIN, timeout=120, env=env)
    assert report["rc"] == 0 and report["done"]["step"] == 6
    assert [r["workers"] for r in report["resumes"]] == [2, 1]
    assert report["resumes"][1]["step"] == 4
    assert len(report["rto_s"]) == 2
    want, want_extra = _state(straight, 4)
    got, got_extra = _state(str(tmp_path / "drill"), 4)
    assert got_extra == want_extra == {"step": 4, "data_pos": 4,
                                       "adam_step": 4}
    assert sorted(got) == sorted(want)
    for name in want:
        w, g = want[name].float(), got[name].float()
        assert torch.all(torch.isfinite(g))
        torch.testing.assert_close(
            g, w, rtol=0, atol=2e-5 * max(w.abs().max().item(), 1e-30))
    losses = [l for s, l, n in report["losses"]]
    assert all(np.isfinite(losses))
