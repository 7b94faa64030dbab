"""Driver and task RPC services for launch-time discovery: the port's
copy of ``horovod_tpu/run/services.py`` over the port's ``run/network``
(a plain lock where the JAX package takes its lockdep-checked one).

Reference: horovod/run/common/service/driver_service.py (task registration,
address book, routable-interface intersection) and task_service.py (remote
command execution). The flow (reference run/run.py:188-257):

  1. driver starts on the launcher host;
  2. one probe task is ssh-launched per remote host; each starts a
     TaskService and registers all its (iface → ip:port) addresses;
  3. each task probes the addresses of the *next* task in ring order and
     registers which interfaces were reachable;
  4. the driver intersects routable interfaces across the ring — those are
     the NICs every host can reach every other host on. The launcher then
     puts the torch.distributed rendezvous on an address of rank 0's host
     on one of them (where the reference instead passed them to mpirun
     as BTL/NCCL socket-interface flags).
"""

import threading

from . import exec_util
from .network import AckResponse, BasicClient, BasicService
from .settings import Timeout


# ---------------------------------------------------------------------------
# wire objects
# ---------------------------------------------------------------------------

class RegisterTaskRequest:
    def __init__(self, index, task_addresses, host_hash):
        self.index = index
        self.task_addresses = task_addresses
        self.host_hash = host_hash


class AllTaskAddressesRequest:
    def __init__(self, index):
        self.index = index


class AllTaskAddressesResponse:
    def __init__(self, all_task_addresses):
        self.all_task_addresses = all_task_addresses


class RegisterTaskToTaskAddressesRequest:
    def __init__(self, index, task_addresses):
        self.index = index
        self.task_addresses = task_addresses


class RunCommandRequest:
    def __init__(self, command, env):
        self.command = command
        self.env = env


class CommandExitCodeRequest:
    pass


class CommandExitCodeResponse:
    def __init__(self, terminated, exit_code):
        self.terminated = terminated
        self.exit_code = exit_code


class ShutdownTaskRequest:
    pass


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

class LaunchDriverService(BasicService):
    NAME = "hvdrun driver service"

    def __init__(self, num_tasks, key):
        super().__init__(self.NAME, key)
        self._num_tasks = num_tasks
        self._all_registered = threading.Event()
        self._all_routable = threading.Event()
        self._lock = threading.Lock()
        self._task_addresses = {}  # guarded_by: _lock
        self._task_host_hash = {}  # guarded_by: _lock
        self._routable = {}        # guarded_by: _lock

    def _handle(self, req, client_address):
        if isinstance(req, RegisterTaskRequest):
            with self._lock:
                self._task_addresses[req.index] = req.task_addresses
                self._task_host_hash[req.index] = req.host_hash
                if len(self._task_addresses) == self._num_tasks:
                    self._all_registered.set()
            return AckResponse()
        if isinstance(req, AllTaskAddressesRequest):
            with self._lock:
                return AllTaskAddressesResponse(
                    self._task_addresses.get(req.index, {}))
        if isinstance(req, RegisterTaskToTaskAddressesRequest):
            with self._lock:
                self._routable[req.index] = req.task_addresses
                if len(self._routable) == self._num_tasks:
                    self._all_routable.set()
            return AckResponse()
        return super()._handle(req, client_address)

    def wait_for_initial_registration(self, timeout: Timeout):
        while not self._all_registered.wait(1.0):
            timeout.check()

    def wait_for_task_to_task_addresses(self, timeout: Timeout):
        while not self._all_routable.wait(1.0):
            timeout.check()

    def task_addresses(self, index):
        with self._lock:
            return dict(self._task_addresses.get(index, {}))

    def task_host_hashes(self):
        with self._lock:
            return dict(self._task_host_hash)

    def common_interfaces(self):
        """Intersect interface names over every ring probe result
        (reference run/run.py:245-255)."""
        with self._lock:
            routable = dict(self._routable)
        sets = [set(v.keys()) for v in routable.values()]
        if not sets:
            return set()
        common = set.intersection(*sets)
        if not common:
            raise RuntimeError(
                "Unable to find a set of network interfaces common to all "
                f"hosts; per-task routable interfaces: {routable}")
        return common


class LaunchDriverClient(BasicClient):
    def __init__(self, addresses, key, probe_timeout=5.0):
        super().__init__(LaunchDriverService.NAME, addresses, key,
                         probe_timeout=probe_timeout)

    def register_task(self, index, task_addresses, host_hash):
        self.request(RegisterTaskRequest(index, task_addresses, host_hash))

    def all_task_addresses(self, index):
        return self.request(AllTaskAddressesRequest(index)).all_task_addresses

    def register_task_to_task_addresses(self, index, task_addresses):
        self.request(RegisterTaskToTaskAddressesRequest(index,
                                                        task_addresses))


# ---------------------------------------------------------------------------
# task
# ---------------------------------------------------------------------------

class LaunchTaskService(BasicService):
    """Per-host probe/exec agent (reference task_service.py)."""

    @staticmethod
    def name_for(index):
        return f"hvdrun task service #{index}"

    def __init__(self, index, key):
        super().__init__(self.name_for(index), key)
        self.index = index
        self._proc = None
        self._exit_code = None
        self._terminated = threading.Event()
        self._shutdown_requested = threading.Event()

    def _handle(self, req, client_address):
        if isinstance(req, RunCommandRequest):
            env = exec_util.filtered_env(req.env)
            self._proc = exec_util.safe_execute(
                req.command, env=env, on_exit=self._on_exit, index=self.index)
            return AckResponse()
        if isinstance(req, CommandExitCodeRequest):
            return CommandExitCodeResponse(self._terminated.is_set(),
                                           self._exit_code)
        if isinstance(req, ShutdownTaskRequest):
            self._shutdown_requested.set()
            return AckResponse()
        return super()._handle(req, client_address)

    def _on_exit(self, index, rc):
        self._exit_code = rc
        self._terminated.set()

    def wait_for_shutdown(self, poll_s=0.5):
        self._shutdown_requested.wait()

    def kill_command(self):
        if self._proc is not None:
            exec_util.terminate_tree(self._proc)


class LaunchTaskClient(BasicClient):
    def __init__(self, index, addresses, key, probe_timeout=5.0):
        super().__init__(LaunchTaskService.name_for(index), addresses, key,
                         probe_timeout=probe_timeout)

    def run_command(self, command, env=None):
        self.request(RunCommandRequest(command, env or {}))

    def command_exit_code(self):
        resp = self.request(CommandExitCodeRequest())
        return resp.terminated, resp.exit_code

    def shutdown_task(self):
        self.request(ShutdownTaskRequest())
