"""Remote probe-task entry point: ``python -m
horovod_tpu_torch.run.task_fn``, the port's copy of
``horovod_tpu/run/task_fn.py`` (the standard library's pickle where the
JAX package takes cloudpickle: the driver's addresses are plain data).

Reference horovod/run/task_fn.py: start a task service, register with the
driver, ring-probe the next task's interfaces, report what was reachable,
then idle until the driver says shutdown.
"""

import base64
import pickle
import sys
import time

from . import hosts, network, secret, services


def codec_dumps(obj) -> str:
    return base64.b64encode(pickle.dumps(obj)).decode("ascii")


def codec_loads(s: str):
    return pickle.loads(base64.b64decode(s.encode("ascii")))


def main(index, num_tasks, driver_addresses_b64, key):
    driver_addresses = codec_loads(driver_addresses_b64)
    task = services.LaunchTaskService(index, key)
    try:
        driver = services.LaunchDriverClient(driver_addresses, key)
        driver.register_task(index, task.addresses(), hosts.host_hash())

        # Ring probe: wait for the next task to register, then ping every
        # one of its advertised (iface, ip:port) pairs (run/task_fn.py:23).
        next_index = (index + 1) % num_tasks
        next_addresses = {}
        while not next_addresses:
            next_addresses = driver.all_task_addresses(next_index)
            if not next_addresses:
                time.sleep(0.5)  # don't hammer the driver while peers start
        reachable = network.probe_reachable(
            services.LaunchTaskService.name_for(next_index),
            next_addresses, key)
        driver.register_task_to_task_addresses(index, reachable)

        task.wait_for_shutdown()
    finally:
        task.kill_command()
        task.shutdown()


if __name__ == "__main__":
    _index = int(sys.argv[1])
    _num = int(sys.argv[2])
    _addrs = sys.argv[3]
    import os
    _key = base64.b64decode(os.environ[secret.HVD_SECRET_KEY])
    main(_index, _num, _addrs, _key)
