"""Elastic resource supervisor: the port's copy of
``horovod_tpu/run/elastic.py`` (reference submitjob.py, the CS744 fork's
contribution), with a plain lock where the JAX package takes its
lockdep-checked one, and the serving-replica control door
(``ReplicaSupervisorService`` / ``ReplicaSupervisorClient``) the router's
elasticity controller changes the replica set through.

The reference daemon listens on a TCP port; a peer sends an integer N
(``echo N | nc node0 5000``) to surrender N slots. The daemon shrinks the
host list, shrinks further until the ORIGINAL total divides the new total
(so the per-step global batch can be preserved exactly), kills the running
``horovodrun``, and restarts it with ``--batches-per-allreduce =
old_total/new_total`` and a load-from-checkpoint flag
(submitjob.py:120-204). This is restart-based elasticity: recovery
correctness comes from the checkpoint + ``broadcast_parameters`` on
startup, not from in-flight migration.

This supervisor keeps those semantics with hvdrun
(``python -m horovod_tpu_torch.run``) as the job runner. It also consumes
two exit codes without a human: ``RanksLostError.EXIT_CODE`` (44,
``--auto-shrink-on-ranks-lost``: shrink and restart) and
``PREEMPTED_EXIT_CODE`` (45, ``--graceful-restart-on-preempt``: restart
on the same slots). Command placeholders: ``{np}`` worker count,
``{hosts}`` host:slots list, ``{bpa}`` batches-per-allreduce,
``{restart}`` restart ordinal (lets the training script decide to
``--loadcp``).
"""

import collections
import socket
import subprocess
import sys
import threading
import time

from ..common import hvd_logging as log
from ..utils import lockdep
from . import exec_util
from .hosts import HostSlots, parse_hosts
from .network import BasicClient, BasicService

DEFAULT_PORTS = (5000, 5001, 5002)


def shrink_hosts(host_list, remove_n, starting_total):
    """Pure rebalance: drop remove_n slots (from the last host backward),
    then keep dropping until starting_total % new_total == 0
    (submitjob.py updateResources/removeAdditionalResources).

    Returns (new_host_list, new_total) or raises if no valid allocation
    remains.
    """
    slots = [h.slots for h in host_list]
    to_remove = remove_n
    while to_remove > 0 and any(slots):
        for i in range(len(slots) - 1, -1, -1):
            if slots[i] > 0:
                slots[i] -= 1
                to_remove -= 1
                break
    new_total = sum(slots)
    while new_total > 0 and starting_total % new_total != 0:
        for i in range(len(slots) - 1, -1, -1):
            if slots[i] > 0:
                slots[i] -= 1
                new_total -= 1
                break
    if new_total <= 0:
        raise ValueError(
            f"Removing {remove_n} slots leaves no valid allocation "
            f"(starting total {starting_total}).")
    new_hosts = [HostSlots(h.hostname, s)
                 for h, s in zip(host_list, slots) if s > 0]
    return new_hosts, new_total


class ElasticSupervisor:
    """Run a job command elastically, restarting with fewer slots on
    demand."""

    def __init__(self, hosts, command, ports=DEFAULT_PORTS, verbose=1,
                 runner=None, auto_shrink_rc=None, shrink_slots=1,
                 max_restarts=10, graceful_restart_rc=None):
        self.hosts = parse_hosts(hosts) if isinstance(hosts, str) else hosts
        self.command = list(command)
        self.starting_total = sum(h.slots for h in self.hosts)
        self.current_total = self.starting_total
        self.ports = ports
        self.verbose = verbose
        # fail-fast consumption: when the job exits with this code (the
        # RanksLostError.EXIT_CODE contract — workers that lost ranks
        # exit with it), shrink by shrink_slots and restart instead of
        # surfacing the failure to a human. None disables. max_restarts
        # bounds the kill/shrink loop so a systematically crashing job
        # cannot shrink-restart forever.
        self.auto_shrink_rc = auto_shrink_rc
        # graceful consumption: this exit code (the preemption-safe
        # PREEMPTED_EXIT_CODE contract — the worker finished its step,
        # committed an emergency checkpoint and exited on purpose) means
        # the allocation is still healthy: restart with the SAME slots,
        # no shrink. None disables; max_restarts bounds it too.
        self.graceful_restart_rc = graceful_restart_rc
        self.shrink_slots = shrink_slots
        self.max_restarts = max_restarts
        self.restarts = 0
        self._exit_code = 0  # GIL-atomic int; listener writes, wait() reads
        self._proc = None    # guarded_by: _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._listener = None
        self._sock = None
        self._runner = runner or self._default_runner
        self.port = None

    # -- job control -------------------------------------------------------

    def _format_command(self):
        hosts_str = ",".join(f"{h.hostname}:{h.slots}" for h in self.hosts)
        subs = {"np": self.current_total, "hosts": hosts_str,
                "bpa": self.starting_total // self.current_total,
                "restart": self.restarts}
        return [c.format(**subs) for c in self.command]

    def _default_runner(self, argv):
        # the job's output goes through this process's own streams
        sys.stdout.flush()
        return exec_util.safe_execute(argv)

    def _start_job(self):
        argv = self._format_command()
        if self.verbose:
            print(f"elastic: starting job (restart #{self.restarts}, "
                  f"np={self.current_total}, "
                  f"bpa={self.starting_total // self.current_total}): "
                  f"{argv}", flush=True)
        self._proc = self._runner(argv)

    def _kill_job(self):
        if self._proc is not None:
            exec_util.terminate_tree(self._proc)
            self._proc = None

    # -- listener ----------------------------------------------------------

    def _bind(self):
        for port in self.ports:
            try:
                s = socket.socket()
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind(("", port))
                s.listen(5)
                s.settimeout(0.5)
                self.port = s.getsockname()[1]
                return s
            except OSError:
                continue
        raise RuntimeError(f"elastic: unable to bind any of {self.ports}")

    def _listen_loop(self):
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                msg = int(self._recv_message(conn))
            except (ValueError, OSError):
                conn.close()
                continue
            try:
                self.remove_slots(msg, source=addr[0])
            except ValueError as e:
                # Bad allocation: kill the job rather than leave it running
                # unsupervised, and report failure (submitjob exits here
                # too, but leaks its horovodrun).
                print(f"elastic: ERROR: {e}")
                self._exit_code = 1
                self.shutdown()
            conn.close()

    @staticmethod
    def _recv_message(conn, max_bytes=64, timeout_s=5.0):
        """Read the peer's whole message: loop recv until EOF. A single
        recv() may legally return any prefix of what the peer sent
        (TCP is a byte stream) — parsing the first chunk alone
        truncates a slot count split across segments. Bounded both
        ways: max_bytes caps memory, the socket timeout caps a peer
        that connects and never closes."""
        conn.settimeout(timeout_s)
        chunks = []
        total = 0
        while True:
            b = conn.recv(1024)
            if not b:
                break
            total += len(b)
            if total > max_bytes:
                raise ValueError(
                    f"elastic control message exceeds {max_bytes} bytes")
            chunks.append(b)
        return b"".join(chunks).strip()

    # -- public API --------------------------------------------------------

    def remove_slots(self, n, source="local"):
        """Shrink by n slots and restart the job (submitjob listener)."""
        with self._lock:
            self._remove_slots_locked(n, source)

    def _remove_slots_locked(self, n, source):
        new_hosts, new_total = shrink_hosts(self.hosts, n,
                                            self.starting_total)
        if self.verbose:
            print(f"elastic: request from {source}: slots "
                  f"{self.current_total}->{new_total}; "
                  f"batches-per-allreduce -> "
                  f"{self.starting_total // new_total}", flush=True)
        self.hosts, self.current_total = new_hosts, new_total
        self._kill_job()
        self.restarts += 1
        self._start_job()

    def start(self):
        self._sock = self._bind()
        self._listener = threading.Thread(target=self._listen_loop,
                                          daemon=True)
        self._listener.start()
        with self._lock:
            self._start_job()
        return self

    def wait(self, poll_s=0.5):
        """Block until the job exits on its own (not via a restart kill).
        Returns its exit code.

        Fail-fast consumption: an exit with ``auto_shrink_rc`` (workers
        lost ranks — RanksLostError.EXIT_CODE) triggers an automatic
        shrink-and-restart, bounded by ``max_restarts``, instead of
        returning: the supervisor recovers around dead ranks without a
        human in the loop (the checkpoint + broadcast_parameters restart
        contract supplies correctness, as for manual shrinks)."""
        while not self._stop.is_set():
            with self._lock:
                proc = self._proc
            if proc is None:
                time.sleep(poll_s)
                continue
            try:
                rc = proc.wait(timeout=poll_s)
            except subprocess.TimeoutExpired:
                continue
            with self._lock:
                if proc is not self._proc:  # replaced by a restart kill
                    continue
                if (self.graceful_restart_rc is not None and
                        rc == self.graceful_restart_rc and
                        self.restarts < self.max_restarts):
                    # preemption-safe exit: the job checkpointed and
                    # left on purpose — same allocation, no shrink
                    if self.verbose:
                        print(f"elastic: job exited with the preempted "
                              f"code {rc}; restarting with the same "
                              f"{self.current_total} slot(s)", flush=True)
                    self.restarts += 1
                    self._start_job()
                    continue
                if (self.auto_shrink_rc is not None and
                        rc == self.auto_shrink_rc and
                        self.restarts < self.max_restarts):
                    if self.verbose:
                        print(f"elastic: job exited with the ranks-lost "
                              f"code {rc}; auto-shrinking by "
                              f"{self.shrink_slots} slot(s)", flush=True)
                    try:
                        self._remove_slots_locked(self.shrink_slots,
                                                  source="ranks-lost")
                        continue
                    except ValueError as e:
                        print(f"elastic: ERROR: cannot shrink further: "
                              f"{e}")
            # falling out of the locked block (no restart path taken)
            # means the job is done; shutdown re-takes the lock itself
            self.shutdown()
            return rc
        return self._exit_code

    def shutdown(self):
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        # under the lock: the listener thread may be mid-restart
        # (_remove_slots_locked kills and respawns _proc while locked),
        # and killing the half-replaced process off-lock would leak the
        # freshly spawned one
        with self._lock:
            self._kill_job()


# ---------------------------------------------------------------------------
# serving-replica control door
#
# The restart-based supervisor above kills and relaunches whole jobs; the
# elasticity controller (router/elastic.py) instead changes the SERVING
# replica set one replica at a time, through this authenticated RPC door.
# Riding BasicService brings the chaos plane along: HVD_CHAOS_SPEC rules
# that name "hvd elastic replica supervisor" drop, duplicate and delay
# these control messages like any other wire traffic.
# ---------------------------------------------------------------------------

class SpawnReplicaRequest:
    """Start one serving replica. ``change_id`` keys the idempotency
    ledger: a duplicate delivery (chaos dup, client retry) returns the
    original response instead of spawning a second replica."""

    def __init__(self, change_id):
        self.change_id = str(change_id)


class DrainReplicaRequest:
    """Gracefully drain one serving replica. Idempotent by
    ``change_id``: a duplicated drain executes once."""

    def __init__(self, change_id, replica_id):
        self.change_id = str(change_id)
        self.replica_id = int(replica_id)


class ReplicaOpResponse:
    def __init__(self, change_id, op, ok, replica_id=None, detail="",
                 duplicate=False):
        self.change_id = change_id
        self.op = op
        self.ok = ok
        self.replica_id = replica_id
        self.detail = detail
        # True when this response was replayed from the idempotency
        # ledger: the operation did NOT execute a second time
        self.duplicate = duplicate


class ReplicaSupervisorService(BasicService):
    """The supervisor end of replica scale changes. ``on_spawn()`` must
    start a replica and return its id; ``on_drain(replica_id)`` must
    begin a graceful drain and return truthiness. Both run under the
    ledger lock, so two racing requests with the same ``change_id``
    execute exactly once; the ledger keeps the newest ``LEDGER_CAP``."""

    NAME = "hvd elastic replica supervisor"
    LEDGER_CAP = 1024

    def __init__(self, key, on_spawn=None, on_drain=None):
        super().__init__(self.NAME, key)
        self._on_spawn = on_spawn
        self._on_drain = on_drain
        self._op_lock = lockdep.lock("ReplicaSupervisorService._op_lock")
        self._ledger = collections.OrderedDict()  # guarded_by: _op_lock

    def _handle(self, req, client_address):
        if isinstance(req, (SpawnReplicaRequest, DrainReplicaRequest)):
            return self._op(req)
        return super()._handle(req, client_address)

    def _op(self, req):
        op = "spawn" if isinstance(req, SpawnReplicaRequest) else "drain"
        with self._op_lock:
            hit = self._ledger.get(req.change_id)
            if hit is not None:
                return ReplicaOpResponse(
                    hit.change_id, hit.op, hit.ok,
                    replica_id=hit.replica_id, detail=hit.detail,
                    duplicate=True)
            try:
                if op == "spawn":
                    if self._on_spawn is None:
                        resp = ReplicaOpResponse(
                            req.change_id, op, False,
                            detail="no spawn hook configured")
                    else:
                        rid = self._on_spawn()
                        resp = ReplicaOpResponse(req.change_id, op, True,
                                                 replica_id=rid)
                else:
                    if self._on_drain is None:
                        resp = ReplicaOpResponse(
                            req.change_id, op, False,
                            replica_id=req.replica_id,
                            detail="no drain hook configured")
                    else:
                        ok = bool(self._on_drain(req.replica_id))
                        resp = ReplicaOpResponse(req.change_id, op, ok,
                                                 replica_id=req.replica_id)
            except Exception as exc:  # fail loud BY NAME, never hang
                log.warning("replica %s %s failed: %r", op,
                            req.change_id, exc)
                resp = ReplicaOpResponse(req.change_id, op, False,
                                         detail=repr(exc))
            self._ledger[req.change_id] = resp
            while len(self._ledger) > self.LEDGER_CAP:
                self._ledger.popitem(last=False)
            return resp


class ReplicaSupervisorClient(BasicClient):
    """Client side of the control door. ``retry_requests`` is safe here
    BECAUSE the service is idempotent by change_id: a retried spawn or
    drain replays the ledger entry, it never executes twice."""

    def __init__(self, addresses, key, probe_timeout=5.0):
        super().__init__(ReplicaSupervisorService.NAME, addresses, key,
                         probe_timeout=probe_timeout,
                         retry_requests=True)

    def spawn_replica(self, change_id):
        return self.request(SpawnReplicaRequest(change_id))

    def drain_replica(self, change_id, replica_id):
        return self.request(DrainReplicaRequest(change_id, replica_id))


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.run.elastic",
        description="Elastic job supervisor (submitjob.py parity). The "
                    "command may use {np} {hosts} {bpa} {restart} "
                    "placeholders.")
    p.add_argument("-H", "--hosts", required=True)
    p.add_argument("--ports", default=",".join(map(str, DEFAULT_PORTS)),
                   help="ports to try for the slot listener, in order "
                        "(0: any free port)")
    p.add_argument("--auto-shrink-on-ranks-lost", action="store_true",
                   help="When the job exits with RanksLostError's exit "
                        "code (workers declared ranks dead), shrink and "
                        "restart automatically instead of exiting.")
    p.add_argument("--graceful-restart-on-preempt", action="store_true",
                   help="When the job exits with the preemption code "
                        "(trainer.Checkpointer's SIGTERM contract: "
                        "emergency checkpoint committed, exit 45), "
                        "restart it with the SAME slots instead of "
                        "exiting — the machine went away, the "
                        "allocation did not.")
    p.add_argument("--shrink-slots", type=int, default=1,
                   help="Slots to drop per automatic shrink (default 1).")
    p.add_argument("--max-restarts", type=int, default=10,
                   help="Bound on automatic shrink-restarts (default 10).")
    p.add_argument("command", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    command = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not command:
        p.error("no command given")
    from ..common.exceptions import PREEMPTED_EXIT_CODE, RanksLostError
    sup = ElasticSupervisor(
        args.hosts, command,
        ports=tuple(int(x) for x in args.ports.split(",")),
        auto_shrink_rc=(RanksLostError.EXIT_CODE
                        if args.auto_shrink_on_ranks_lost else None),
        graceful_restart_rc=(PREEMPTED_EXIT_CODE
                             if args.graceful_restart_on_preempt
                             else None),
        shrink_slots=args.shrink_slots,
        max_restarts=args.max_restarts).start()
    print(f"elastic: listening on port {sup.port}; send an integer to "
          f"surrender that many slots (echo 2 | nc <host> {sup.port})",
          flush=True)
    raise SystemExit(sup.wait())


if __name__ == "__main__":
    main()
