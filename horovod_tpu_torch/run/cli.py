"""``hvdrun`` for the port: ``python -m horovod_tpu_torch.run``.

The port of ``horovod_tpu/run/cli.py`` (reference bin/horovodrun →
run/run.py). Where the reference discovers routable NICs and then execs
``mpirun`` (run/run.py:458-481), hvdrun uses the same discovery (ssh
checks, task-service ring probing) to choose the rendezvous address and
spawns every worker itself — locally as a subprocess, remotely through
ssh — with the rendezvous in its environment:

    HVD_COORDINATOR_ADDR  host:port of rank 0's torch.distributed store
    HVD_NUM_PROC          total worker count (== -np)
    HVD_PROCESS_ID        this worker's global rank
    HVD_LOCAL_RANK/SIZE   rank/size within the host
    HVD_CROSS_RANK/SIZE   host index / host count

which ``mpi_ops.init`` reads, and the job's secret (``_HVD_SECRET_KEY``
and ``HVD_SECRET_KEY``, base64) that keys the eager core's negotiation
wire. Workers that share one card (``HVD_LOCAL_SIZE`` above the card
count) join gloo over CUDA tensors: NCCL refuses two ranks on one
device (``mpi_ops.init``).

Exit codes: the first nonzero child code is passed on, and one failed
worker stops the others, as an MPI abort would — with two exceptions
that the elastic supervisor (``run/elastic.py``) depends on. A SIGTERM
to hvdrun is forwarded to every worker, which then finishes its step,
saves and exits ``PREEMPTED_EXIT_CODE`` (45): hvdrun waits for all of
them (up to ``TERM_GRACE_S``) and passes 45 on. A worker killed by a
signal hvdrun did not send is a lost rank: the survivors get
``LOST_GRACE_S`` to notice and exit on their own
(``RanksLostError.EXIT_CODE``, 44), and a survivor's own code is passed
on before the lost rank's.
"""

import argparse
import base64
import os
import signal
import sys
import time

from ..common.exceptions import PREEMPTED_EXIT_CODE
from ..ops.negotiation import CONTROL_PORT_SPAN
from . import cache as cache_mod
from . import exec_util, hosts, secret, services, task_fn
from .network import free_port as _free_port
from .settings import Settings, Timeout

# seconds the workers get to save and exit after a forwarded SIGTERM
TERM_GRACE_S = 300.0
# seconds the survivors of a lost rank get to exit on their own
LOST_GRACE_S = 60.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.run",
        description="Launch a horovod_tpu_torch training job.",
        usage="python -m horovod_tpu_torch.run -np N [-H hosts] command...")
    p.add_argument("-np", "--num-proc", type=int, required=True,
                   help="Total number of worker processes.")
    p.add_argument("-H", "--hosts", default=None,
                   help="Comma-separated host:slots list "
                        "(default: localhost:np).")
    p.add_argument("-p", "--ssh-port", type=int, default=None,
                   help="SSH port for remote hosts.")
    p.add_argument("--start-timeout", type=int,
                   default=int(os.environ.get("HOROVOD_START_TIMEOUT", 600)),
                   help="Seconds to wait for all workers to start.")
    p.add_argument("--disable-cache", action="store_true",
                   help="Do not reuse cached ssh/interface check results.")
    p.add_argument("--verbose", "-v", action="count", default=0)
    p.add_argument("--output-filename", "--output-dir", dest="output_dir",
                   default=None,
                   help="Redirect each rank's stdout/stderr to "
                        "<dir>/rank.<i>.{out,err}.")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="Training command, e.g. python train.py")
    args = p.parse_args(argv)
    if not args.command:
        p.error("no command given")
    if args.command[0] == "--":
        args.command = args.command[1:]
    return args


def _discover_coordinator_ip(host_list, settings):
    """Find an IP every host can route to (reference run/run.py:188-257).

    Starts the driver service, ssh-launches one probe task per host,
    waits for the ring-probe results, intersects the interfaces, and
    returns rank 0's host's address on a common one."""
    driver = services.LaunchDriverService(len(host_list), settings.key)
    procs = []
    try:
        addrs_b64 = task_fn.codec_dumps(driver.addresses())
        key_b64 = base64.b64encode(settings.key).decode("ascii")
        for i, h in enumerate(host_list):
            cmd = [sys.executable, "-m", "horovod_tpu_torch.run.task_fn",
                   str(i), str(len(host_list)), addrs_b64]
            if hosts.is_local(h.hostname):
                env = exec_util.filtered_env(
                    {secret.HVD_SECRET_KEY: key_b64})
                procs.append(exec_util.safe_execute(cmd, env=env))
            else:
                ssh = ["ssh"] + hosts.SSH_OPTS
                if settings.ssh_port:
                    ssh += ["-p", str(settings.ssh_port)]
                remote = ["env", f"{secret.HVD_SECRET_KEY}={key_b64}"] + \
                    exec_util.forwarded_env_flags(quote=True) + \
                    exec_util.quote_argv(cmd)
                procs.append(exec_util.safe_execute(
                    ssh + [h.hostname] + remote))
        timeout = Timeout(settings.start_timeout_s,
                          "Timed out waiting for launch probe tasks. "
                          "Check ssh connectivity and firewalls.")
        driver.wait_for_initial_registration(timeout)
        driver.wait_for_task_to_task_addresses(timeout)
        common = driver.common_interfaces()
        if settings.verbose:
            print(f"hvdrun: common interfaces: {sorted(common)}")
        for i in range(len(host_list)):
            try:
                services.LaunchTaskClient(
                    i, driver.task_addresses(i), settings.key).shutdown_task()
            except Exception:  # noqa: BLE001 — probes are torn down below
                pass
        # rank 0 binds the store, so the address must be rank 0's host's
        # (host_list[0]), not the launcher's
        rank0_addrs = driver.task_addresses(0)
        for iface in sorted(common):
            if iface in rank0_addrs:
                return rank0_addrs[iface][0][0]
        raise RuntimeError(
            f"Rank-0 host {host_list[0].hostname} has no address on common "
            f"interfaces {common}")
    finally:
        for proc in procs:
            exec_util.terminate_tree(proc, grace_s=1.0)
        driver.shutdown()


def _rank_env(rank, local_rank, host_index, h, n_proc, n_hosts,
              coordinator_addr):
    return {
        "HVD_COORDINATOR_ADDR": coordinator_addr,
        "HVD_NUM_PROC": n_proc,
        "HVD_PROCESS_ID": rank,
        "HVD_LOCAL_RANK": local_rank,
        "HVD_LOCAL_SIZE": h.slots,
        "HVD_CROSS_RANK": host_index,
        "HVD_CROSS_SIZE": n_hosts,
    }


def _exit_status(rc):
    """A child's return code as an exit status (a signal N as 128 + N)."""
    return 128 - rc if rc < 0 else rc


class _Job:
    """The spawned workers and the exit-code policy of the module
    docstring."""

    def __init__(self, procs, term_grace, lost_grace):
        self.procs = procs
        self.term_grace = term_grace
        self.lost_grace = lost_grace
        self.forwarded = False   # hvdrun forwarded a SIGTERM
        self.deadline = None

    def forward_term(self):
        if self.forwarded:   # a second SIGTERM: stop waiting
            self.deadline = time.monotonic()
            return
        self.forwarded = True
        self.deadline = time.monotonic() + self.term_grace
        # runs in the SIGTERM handler: ``returncode`` is a plain read,
        # where ``poll()`` would take the Popen's waitpid lock
        for p in self.procs:
            if p.returncode is None:
                try:
                    os.killpg(os.getpgid(p.pid), signal.SIGTERM)
                except OSError:
                    pass   # already exited

    def wait(self, cancel_event=None):
        pending = set(range(len(self.procs)))
        codes = []   # nonzero codes in the order they were seen
        while pending:
            if cancel_event is not None and cancel_event.is_set():
                exec_util.terminate_trees([self.procs[j]
                                           for j in sorted(pending)])
                return codes[0] if codes else 130
            for i in sorted(pending):
                rc = self.procs[i].poll()
                if rc is None:
                    continue
                pending.discard(i)
                if rc == 0:
                    continue
                codes.append(rc)
                if self.forwarded or rc == PREEMPTED_EXIT_CODE:
                    # the others are finishing their step and saving
                    if self.deadline is None:
                        self.deadline = time.monotonic() + self.term_grace
                elif rc < 0:
                    # a lost rank: the survivors notice and exit
                    if self.deadline is None:
                        self.deadline = time.monotonic() + self.lost_grace
                elif self.deadline is None:
                    # one failed worker aborts the job (mpirun's semantics)
                    self.deadline = time.monotonic()
            if pending and self.deadline is not None and \
                    time.monotonic() >= self.deadline:
                exec_util.terminate_trees([self.procs[j]
                                           for j in sorted(pending)])
                for j in sorted(pending):
                    rc = self.procs[j].poll()
                    if rc:
                        codes.append(rc)
                pending.clear()
            time.sleep(0.05)
        if not codes:
            return 0
        own = [c for c in codes if c > 0]   # codes the workers chose
        return _exit_status(own[0] if own else codes[0])


def run_command_on_hosts(host_list, command, coordinator_addr, settings,
                         output_dir=None, extra_env=None, cancel_event=None,
                         term_grace=TERM_GRACE_S, lost_grace=LOST_GRACE_S,
                         on_spawn=None):
    """Spawn every worker, wait, and return the job's exit code (the
    policy of the module docstring). Setting ``cancel_event`` terminates
    every worker (exit 130). ``on_spawn(job)`` receives the running job
    (its ``forward_term`` is the SIGTERM forwarder)."""
    n_proc = sum(h.slots for h in host_list)
    procs = []
    files = []
    try:
        rank = 0
        for host_index, h in enumerate(host_list):
            for local_rank in range(h.slots):
                env_over = _rank_env(rank, local_rank, host_index, h, n_proc,
                                     len(host_list), coordinator_addr)
                if extra_env:
                    env_over.update(extra_env)
                stdout = stderr = None
                if output_dir:
                    os.makedirs(output_dir, exist_ok=True)
                    stdout = open(os.path.join(output_dir,
                                               f"rank.{rank}.out"), "wb")
                    stderr = open(os.path.join(output_dir,
                                               f"rank.{rank}.err"), "wb")
                    files += [stdout, stderr]
                if hosts.is_local(h.hostname):
                    env = exec_util.filtered_env(env_over)
                    procs.append(exec_util.safe_execute(
                        command, env=env, stdout=stdout, stderr=stderr))
                else:
                    ssh = ["ssh"] + hosts.SSH_OPTS
                    if settings.ssh_port:
                        ssh += ["-p", str(settings.ssh_port)]
                    remote = ["env"] + \
                        exec_util.quote_argv(
                            f"{k}={v}" for k, v in env_over.items()) + \
                        exec_util.forwarded_env_flags(quote=True) + \
                        exec_util.quote_argv(command)
                    procs.append(exec_util.safe_execute(
                        ssh + [h.hostname] + remote,
                        stdout=stdout, stderr=stderr))
                rank += 1
        job = _Job(procs, term_grace, lost_grace)
        if on_spawn is not None:
            on_spawn(job)
        return job.wait(cancel_event)
    except BaseException:
        # a spawn failure mid-loop or Ctrl-C: never leak started workers
        exec_util.terminate_trees(procs)
        if isinstance(sys.exc_info()[1], KeyboardInterrupt):
            return 130
        raise
    finally:
        for f in files:
            f.close()


def main(argv=None):
    args = parse_args(argv)
    host_list = (hosts.parse_hosts(args.hosts) if args.hosts
                 else [hosts.HostSlots("localhost", args.num_proc)])
    n_slots = sum(h.slots for h in host_list)
    if n_slots < args.num_proc:
        sys.exit(f"hvdrun: -np {args.num_proc} but only {n_slots} slots in "
                 f"host list")

    key_env = os.environ.get("HOROVOD_SECRET_KEY") or \
        os.environ.get("HVD_SECRET_KEY")
    settings = Settings(
        num_proc=args.num_proc, hosts=host_list, command=args.command,
        key=(base64.b64decode(key_env) if key_env
             else secret.make_secret_key()),
        start_timeout_s=args.start_timeout, ssh_port=args.ssh_port,
        verbose=args.verbose)

    remote = [h.hostname for h in host_list
              if not hosts.is_local(h.hostname)]
    if remote:
        fn_cache = None if args.disable_cache else cache_mod.Cache()
        hosts.check_all_hosts_ssh_successful(remote, fn_cache=fn_cache)
        coordinator_ip = _discover_coordinator_ip(host_list, settings)
    else:
        coordinator_ip = "127.0.0.1"
    # rank 0 binds the store; probing a free port means something only
    # when rank 0's host is this machine
    if hosts.is_local(host_list[0].hostname):
        # the eager core's control plane binds a port in [rendezvous +
        # 1000, + 1000 + CONTROL_PORT_SPAN): keep that range valid
        coordinator_port = _free_port()
        while coordinator_port + 1000 + CONTROL_PORT_SPAN > 65535:
            coordinator_port = _free_port()
    else:
        import random
        coordinator_port = random.randrange(30000, 60000)
    coordinator_addr = f"{coordinator_ip}:{coordinator_port}"
    if args.verbose:
        print(f"hvdrun: launching {args.num_proc} processes on "
              f"{len(host_list)} host(s); rendezvous {coordinator_addr}")
    # workers run in process groups of their own (safe_execute), so a
    # SIGTERM to hvdrun alone would strand them: forward it
    jobs = []

    def on_term(signum, frame):
        for job in jobs:
            job.forward_term()
    try:
        signal.signal(signal.SIGTERM, on_term)
    except ValueError:
        pass  # not the main thread
    # the per-job secret keys the eager core's negotiation wire
    key_b64 = base64.b64encode(settings.key).decode("ascii")
    sys.exit(run_command_on_hosts(
        host_list, args.command, coordinator_addr, settings,
        output_dir=args.output_dir,
        extra_env={secret.HVD_SECRET_KEY: key_b64,
                   "HVD_SECRET_KEY": key_b64},
        on_spawn=jobs.append))


if __name__ == "__main__":
    main()
