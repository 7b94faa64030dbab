"""The eager core's two-level allreduce on groups of its own.

Four gloo ranks as two hosts of two (``HVD_LOCAL_SIZE=2``), spawned
once for the module with ``HOROVOD_HIERARCHICAL_ALLREDUCE=1`` and
``HVD_SECRET_KEY`` set (the negotiated mode). ``init`` builds the core's
``chips`` groups (the ranks of one host) and ``slices`` groups (the
ranks at one position on every host) out of the core's own process
group; they are not the hierarchy mesh's groups that
``DistributedOptimizer``'s hooks and the mesh collectives reduce over,
so the core's background thread never shares a communicator with them.
In one step an eager allreduce and a grouped allreduce are in flight
while a ``DistributedOptimizer(SGD)`` step reduces its gradients through
the hierarchy mesh: the eager sums are exact on integers and within
1e-6 relative on floats, and the parameters equal those of the same
step taken on the mean of the four ranks' gradients, within 1e-6
relative (the sums are taken in another order). With the flag turned
off the core takes its flat engine.
"""

import base64
import os
import socket
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from horovod_tpu_torch import mpi_ops, optim
from horovod_tpu_torch.common import state as state_mod
from horovod_tpu_torch.ops import operation_manager as tom
from horovod_tpu_torch.parallel import mesh as tmesh

WORLD, LOCAL = 4, 2
JOIN_TIMEOUT_S = 120


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(6, 10), torch.nn.Tanh(),
                               torch.nn.Linear(10, 3))


def _batch(r):
    g = np.random.RandomState(r)
    return (torch.from_numpy(g.randn(8, 6).astype(np.float32)),
            torch.from_numpy(g.randn(8, 3).astype(np.float32)))


def _loss(model, batch):
    return torch.nn.functional.mse_loss(model(batch[0]), batch[1])


def _reference_params():
    """One SGD(0.1) step of ``_model`` on the mean of every rank's
    gradients, taken on one process."""
    model = _model()
    grads = [torch.autograd.grad(_loss(model, _batch(r)),
                                 list(model.parameters()))
             for r in range(WORLD)]
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p -= 0.1 * sum(g[i] for g in grads) / WORLD
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _groups(r):
    coord = state_mod.global_state().coordinator
    hier = coord._allreduce_engine()
    mesh = tmesh.hierarchy_mesh()
    mine = [a.group for a in hier.axes]
    theirs = [mesh.group("chips"), mesh.group("slices"), coord.group,
              None]
    return {"engine": type(hier).__name__,
            "ranks": [dist.get_process_group_ranks(g) for g in mine],
            "shared": any(g is t for g in mine for t in theirs)}


def _step(r):
    coord = state_mod.global_state().coordinator
    calls = []
    hier = coord._hier
    plain = hier.allreduce
    hier.allreduce = lambda buf: (calls.append(buf.numel()), plain(buf))[1]
    manager = tom.get_operation_manager()
    manager.selected.clear()
    ints = torch.arange(7, dtype=torch.int32) * (r + 1)
    floats = [torch.full((5,), float(r) + 0.25), torch.arange(3.0) * r]
    h = mpi_ops.allreduce_async(ints, average=False, name="ints")
    hs = mpi_ops.grouped_allreduce_async(floats, average=False,
                                         name="floats")
    model = _model()
    opt = optim.DistributedOptimizer(
        optim.SGD(model.parameters(), 0.1),
        named_parameters=model.named_parameters())
    opt.zero_grad()
    _loss(model, _batch(r)).backward()
    opt.step()
    out = {"ints": mpi_ops.synchronize(h).numpy(),
           "floats": [mpi_ops.synchronize(x).numpy() for x in hs],
           "params": {n: p.detach().numpy().copy()
                      for n, p in model.named_parameters()},
           "core_calls": len(calls),
           "selected": dict(manager.selected)}
    cfg = state_mod.global_state().config
    cfg.hierarchical_allreduce = False
    try:
        flat = mpi_ops.allreduce(torch.ones(4) * r, average=False,
                                 name="flat")
    finally:
        cfg.hierarchical_allreduce = True
    out["flat"] = flat.numpy()
    out["flat_core_calls"] = len(calls) - out["core_calls"]
    return out


def _worker(r, port, cport, results):
    torch.set_num_threads(1)   # four ranks share the host's cores
    os.environ["HVD_LOCAL_SIZE"] = str(LOCAL)
    os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
    os.environ["HVD_CONTROL_ADDR"] = f"localhost:{cport}"
    os.environ["HVD_SECRET_KEY"] = base64.b64encode(b"h" * 32).decode()
    report = {}
    try:
        mpi_ops.init(device="cpu", rank=r, size=WORLD,
                     init_method=f"tcp://localhost:{port}")
        report["negotiated"] = state_mod.global_state().coordinator.negotiated
        for name, job in (("groups", _groups), ("step", _step)):
            try:
                report[name] = job(r)
            except Exception:  # noqa: BLE001 — reported to the parent
                report[name] = traceback.format_exc()
        tmesh.reset_global_mesh()
        mpi_ops.shutdown()
    except Exception:  # noqa: BLE001
        report["init"] = traceback.format_exc()
    results.put((r, report))


@pytest.fixture(scope="module")
def reports():
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port, cport = _free_port(), _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, cport, results))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(WORLD):
            r, report = results.get(timeout=JOIN_TIMEOUT_S)
            got[r] = report
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    assert sorted(got) == list(range(WORLD))
    for r in range(WORLD):
        assert "init" not in got[r], got[r]["init"]
        assert got[r]["negotiated"] is True
    return got


def _report(reports, name):
    for r in range(WORLD):
        assert not isinstance(reports[r][name], str), \
            f"rank {r}:\n{reports[r][name]}"
    return [reports[r][name] for r in range(WORLD)]


def test_core_builds_its_own_two_level_groups(reports):
    for r, got in enumerate(_report(reports, "groups")):
        host = r // LOCAL * LOCAL
        assert got["engine"] == "HierarchicalProcessEngine"
        assert got["ranks"] == [[host, host + 1], [r % LOCAL,
                                                   r % LOCAL + LOCAL]]
        assert not got["shared"]


def test_eager_allreduce_rides_the_core_hierarchy(reports):
    ints = sum(np.arange(7, dtype=np.int32) * (r + 1) for r in range(WORLD))
    floats = [sum(np.full(5, r + 0.25, np.float32) for r in range(WORLD)),
              sum(np.arange(3.0, dtype=np.float32) * r
                  for r in range(WORLD))]
    for got in _report(reports, "step"):
        np.testing.assert_array_equal(got["ints"], ints)
        for have, want in zip(got["floats"], floats):
            np.testing.assert_allclose(have, want, rtol=1e-6)
        # the ints alone and the two floats fused: two collectives at least
        assert got["core_calls"] >= 2


def test_distributed_optimizer_beside_the_eager_core(reports):
    want = _reference_params()
    for r, got in enumerate(_report(reports, "step")):
        # the hooks' reductions and the core's both take the two-level
        # backend, the core's on its own groups
        assert set(got["selected"]) == {"hierarchical"}
        assert got["selected"]["hierarchical"] > got["core_calls"]
        for name, p in got["params"].items():
            np.testing.assert_allclose(p, want[name], rtol=1e-6,
                                       atol=1e-6 * np.abs(want[name]).max(),
                                       err_msg=f"rank {r} {name}")


def test_flag_off_takes_the_flat_engine(reports):
    for got in _report(reports, "step"):
        np.testing.assert_array_equal(got["flat"], np.full(4, 6.0))
        assert got["flat_core_calls"] == 0
