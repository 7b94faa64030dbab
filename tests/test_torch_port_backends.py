"""horovod_tpu_torch's collective backends against the JAX package's: the
explicit ring collectives, the hierarchical allreduce, the two-level
mesh and the operation manager's dispatch.

Four gloo ranks, spawned once for the module, laid out as slices 2 ×
chips 2 (``HVD_LOCAL_SIZE=2``: two ranks a host), run
``ring_reduce_scatter``, ``ring_all_gather``, ``ring_all_reduce``,
``ring_all_reduce_overlapped`` and ``hierarchical_allreduce`` on
numpy-seeded per-rank tensors whose sizes do not all divide by 4, with
and without ``average``; the tests hold each rank's result to the JAX
function under ``shard_map`` on 4 virtual CPU devices (axis ``hvd``, or
``build_hierarchical_mesh(2)``), fp32 within 1e-6 relative (the sums are
taken in other orders) and exactly on integer-valued inputs. Each rank
also takes one ``DistributedOptimizer(SGD)`` step under each flag
(none, ``ring_allreduce``, ``hierarchical_allreduce``; the hierarchy
inferred from the hosts), which must equal the flag-less step within
1e-6 of each parameter's largest magnitude, with the operation manager's
selections counted; and ``mpi_ops.allreduce`` and ``grouped_allreduce``
under each flag. Without ranks: ``build_hierarchical_mesh`` and
``infer_slice_structure`` against the JAX functions, and the manager's
choice over the flag × axes table of tests/test_operation_manager.py.
"""

import os
import socket
import traceback
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as JP

from horovod_tpu_torch import mpi_ops, optim
from horovod_tpu_torch.common import state as state_mod
from horovod_tpu_torch.ops import operation_manager as tom
from horovod_tpu_torch.parallel import hierarchical as thier
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import ring_collectives as trc

WORLD = 4
JOIN_TIMEOUT_S = 240
SHAPES = ((7, 3), (5,), (4, 4), (1,))
AVERAGE = (False, True)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _inputs(shape, integer=False):
    """Every rank's input, stacked: ``[WORLD, *shape]``."""
    r = np.random.RandomState(sum(shape) + 10 * integer)
    if integer:
        return r.randint(-50, 50, (WORLD,) + shape).astype(np.float32)
    return r.randn(WORLD, *shape).astype(np.float32)


def _overlap_fn(chunk):
    return chunk * 0.5 + 1.0


# ---------------------------------------------------------------------------
# the rank side


def _collectives(r):
    out = {}
    for shape in SHAPES:
        for integer in (False, True):
            x = torch.from_numpy(_inputs(shape, integer)[r])
            for avg in AVERAGE:
                key = (shape, integer, avg)
                out[("rs",) + key] = trc.ring_reduce_scatter(
                    x, average=avg).numpy()
                out[("ar",) + key] = trc.ring_all_reduce(
                    x, average=avg).numpy()
                out[("ovl",) + key] = trc.ring_all_reduce_overlapped(
                    x, _overlap_fn, average=avg).numpy()
                out[("hier",) + key] = thier.hierarchical_allreduce(
                    x, average=avg).numpy()
            out[("ag",) + (shape, integer)] = trc.ring_all_gather(
                x.reshape(-1)).numpy()
    return out


def _model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(6, 10), torch.nn.Tanh(),
                               torch.nn.Linear(10, 3))


def _dist_step(r, flag):
    """One DistributedOptimizer(SGD) step on this rank's batch with
    ``flag`` on; returns the parameters and the manager's selections."""
    cfg = state_mod.global_state().config
    manager = tom.get_operation_manager()
    manager.selected.clear()
    if flag:
        setattr(cfg, flag, True)
    try:
        model = _model()
        opt = optim.DistributedOptimizer(
            optim.SGD(model.parameters(), 0.1, momentum=0.9),
            named_parameters=model.named_parameters())
        g = np.random.RandomState(r)
        x = torch.from_numpy(g.randn(8, 6).astype(np.float32))
        y = torch.from_numpy(g.randn(8, 3).astype(np.float32))
        for _ in range(2):
            opt.zero_grad()
            torch.nn.functional.mse_loss(model(x), y).backward()
            opt.step()
        ones = torch.arange(5, dtype=torch.float32) + r
        reduced = mpi_ops.allreduce(ones, average=False)
        grouped = mpi_ops.grouped_allreduce([ones, ones[:3] * 2],
                                            average=True)
    finally:
        if flag:
            setattr(cfg, flag, False)
    return {"params": {n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()},
            "selected": dict(manager.selected),
            "allreduce": reduced.numpy(),
            "grouped": [t.numpy() for t in grouped]}


def _worker(r, port, results):
    torch.set_num_threads(1)   # four ranks share the host's cores
    os.environ["HVD_LOCAL_SIZE"] = "2"   # two hosts of two ranks
    report = {}
    try:
        mpi_ops.init(device="cpu", rank=r, size=WORLD,
                     init_method=f"tcp://localhost:{port}")
        jobs = {"slices": lambda: tmesh.infer_slice_structure(),
                "collectives": lambda: _collectives(r)}
        for flag in (None, "ring_allreduce", "hierarchical_allreduce"):
            jobs[f"step_{flag}"] = (lambda flag=flag: _dist_step(r, flag))
        for name, job in jobs.items():
            try:
                report[name] = job()
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
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, results))
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
    return got


def _report(reports, name):
    for r in range(WORLD):
        assert not isinstance(reports[r][name], str), \
            f"rank {r}:\n{reports[r][name]}"
    return [reports[r][name] for r in range(WORLD)]


# ---------------------------------------------------------------------------
# the JAX side: each function under shard_map on 4 virtual devices


def _shard_map(fn, x, mesh, axes):
    return np.asarray(jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=JP(axes), out_specs=JP(axes)))(x))


def _ring_mesh():
    return JaxMesh(np.asarray(jax.devices()[:WORLD]), ("hvd",))


def _jax_ring(op, x, avg):
    from horovod_tpu.parallel import ring_collectives as jrc
    fns = {"rs": lambda t: jrc.ring_reduce_scatter(t[0], "hvd", avg)[None],
           "ar": lambda t: jrc.ring_all_reduce(t[0], "hvd", avg)[None],
           "ovl": lambda t: jrc.ring_all_reduce_overlapped(
               t[0], _overlap_fn, "hvd", avg)[None]}
    return _shard_map(fns[op], jnp.asarray(x), _ring_mesh(), "hvd")


def _jax_hier(x, avg):
    from horovod_tpu.parallel import hierarchical as jhier
    from horovod_tpu.parallel import mesh as jmesh
    mesh = jmesh.build_hierarchical_mesh(2, devices=jax.devices()[:WORLD])
    return _shard_map(
        lambda t: jhier.hierarchical_allreduce(t[0], average=avg)[None],
        jnp.asarray(x), mesh, ("slices", "chips"))


def _close(got, want, integer):
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("avg", AVERAGE)
@pytest.mark.parametrize("op", ["rs", "ar", "ovl"])
def test_ring_collectives_match_jax(hvd, reports, op, shape, integer, avg):
    got = _report(reports, "collectives")
    x = _inputs(shape, integer)
    want = _jax_ring(op, x, avg)
    for r in range(WORLD):
        _close(got[r][(op, shape, integer, avg)], want[r],
               integer and not avg)
    if op == "ar":   # and the plain sum
        total = x.sum(0) / (WORLD if avg else 1)
        for r in range(WORLD):
            _close(got[r][(op, shape, integer, avg)], total,
                   integer and not avg)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("integer", [False, True])
def test_ring_all_gather_matches_jax(hvd, reports, shape, integer):
    from horovod_tpu.parallel import ring_collectives as jrc
    got = _report(reports, "collectives")
    x = _inputs(shape, integer).reshape(WORLD, -1)
    want = _shard_map(lambda t: jrc.ring_all_gather(t[0], "hvd")[None],
                      jnp.asarray(x), _ring_mesh(), "hvd")
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r][("ag", shape, integer)],
                                      want[r])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("avg", AVERAGE)
def test_hierarchical_allreduce_matches_jax(hvd, reports, shape, integer,
                                            avg):
    got = _report(reports, "collectives")
    x = _inputs(shape, integer)
    want = _jax_hier(x, avg)
    for r in range(WORLD):
        _close(got[r][("hier", shape, integer, avg)], want[r],
               integer and not avg)
        _close(got[r][("hier", shape, integer, avg)],
               x.sum(0) / (WORLD if avg else 1), integer and not avg)


@pytest.mark.parametrize("flag", ["ring_allreduce", "hierarchical_allreduce"])
def test_distributed_step_under_each_flag_equals_the_flagless(reports, flag):
    base = _report(reports, "step_None")
    got = _report(reports, f"step_{flag}")
    backend = {"ring_allreduce": "ring",
               "hierarchical_allreduce": "hierarchical"}[flag]
    for r in range(WORLD):
        assert set(base[r]["selected"]) == {"nccl"}
        # every bucket of both steps and both allreduces took the backend
        assert set(got[r]["selected"]) == {backend}
        assert got[r]["selected"][backend] == base[r]["selected"]["nccl"]
        for n, a in base[r]["params"].items():
            np.testing.assert_allclose(got[r]["params"][n], a, rtol=0,
                                       atol=1e-6 * np.abs(a).max(),
                                       err_msg=f"{flag} rank {r} {n}")
            np.testing.assert_allclose(got[r]["params"][n],
                                       got[0]["params"][n], rtol=0, atol=0)
        want = sum(np.arange(5, dtype=np.float32) + q for q in range(WORLD))
        np.testing.assert_array_equal(got[r]["allreduce"], want)
        np.testing.assert_allclose(got[r]["grouped"][0], want / WORLD,
                                   rtol=1e-6)
        np.testing.assert_allclose(got[r]["grouped"][1],
                                   want[:3] * 2 / WORLD, rtol=1e-6)


def test_slices_are_hosts(reports):
    """Two ranks a host: slices [0, 1] and [2, 3]."""
    for got in _report(reports, "slices"):
        assert got == [[0, 1], [2, 3]]


# ---------------------------------------------------------------------------
# the mesh and the dispatch table, no ranks needed


@pytest.mark.parametrize("slices", [1, 2, 4])
def test_build_hierarchical_mesh_matches_jax(hvd, slices):
    from horovod_tpu.parallel import mesh as jmesh
    devices = jax.devices()[:WORLD]
    want = jmesh.build_hierarchical_mesh(slices, devices=devices)
    got = tmesh.build_hierarchical_mesh(slices, devices=list(range(WORLD)))
    assert got.axis_names == want.axis_names == ("slices", "chips")
    ids = np.vectorize(lambda d: devices.index(d))(want.devices)
    np.testing.assert_array_equal(got.devices, ids)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.build_hierarchical_mesh(3, devices=list(range(WORLD)))


def test_infer_slice_structure_matches_jax_on_one_host(hvd):
    """One host (the JAX package's CPU devices all share one process; the
    port, not initialized, knows of no hosts): one slice of every rank."""
    from horovod_tpu.parallel import mesh as jmesh
    devices = jax.devices()[:WORLD]
    want = [[devices.index(d) for d in g]
            for g in jmesh.infer_slice_structure(devices)]
    assert tmesh.infer_slice_structure(list(range(WORLD))) == want == [
        list(range(WORLD))]


_TABLE = (
    # (ring, hierarchical, axis, bound axes)
    (False, False, "hvd", ["hvd"]),
    (True, False, "hvd", ["hvd"]),
    (True, False, ("slices", "chips"), ["slices", "chips"]),
    (True, True, ("slices", "chips"), ["slices", "chips"]),
    (True, True, "chips", ["slices", "chips"]),
    (False, True, ("slices", "chips"), ["slices"]),
    (False, True, ("slices", "chips"), ["slices", "chips"]),
    (False, False, ("slices", "chips"), ["slices", "chips"]),
)


@pytest.mark.parametrize("ring,hier,axis,bound", _TABLE)
def test_manager_choice_matches_jax(hvd, ring, hier, axis, bound):
    """The backend each (flags, axis, bound axes) selects, the port's
    'nccl' standing for the JAX package's 'xla'."""
    from horovod_tpu.ops import operation_manager as jom
    cfg = types.SimpleNamespace(ring_allreduce=ring,
                                hierarchical_allreduce=hier)
    want = jom.OperationManager()._select(axis, bound, cfg).name
    got = tom.OperationManager()._select(axis, bound, cfg).name
    assert got == {"xla": "nccl"}.get(want, want)


# ---------------------------------------------------------------------------
# ranks that are threads of this process (as chip_smoke.py runs them on
# one card): the same routes over a ThreadMesh


def test_thread_ranks_reduce_under_each_flag():
    """Four thread ranks (slices 2 × chips 2, ``thread_meshes``), each
    with its own batch, through ``DistributedOptimizer`` over the thread
    world: under no flag (the thread group's own all-reduce), the ring
    and the hierarchical flag, every rank's averaged gradients equal the
    mean of the ranks' local ones within 1e-6 of the gradients' largest
    magnitude, the manager selecting only the flag's backend. The thread
    group's all-reduce writes each bucket back into the buffer it read:
    a rank that overwrote its buffer before the others had read it would
    break the no-flag route."""
    import copy
    import threading
    mpi_ops.init(device="cpu")
    views = tmesh.thread_meshes(tmesh.build_hierarchical_mesh(
        2, devices=list(range(WORLD))))
    base = _model()
    g = np.random.RandomState(5)
    xs = torch.from_numpy(g.randn(WORLD, 8, 6).astype(np.float32))
    ys = torch.from_numpy(g.randn(WORLD, 8, 3).astype(np.float32))
    cfg = state_mod.global_state().config
    try:
        for flag, backend in ((None, "nccl"), ("ring_allreduce", "ring"),
                              ("hierarchical_allreduce", "hierarchical")):
            out = [None] * WORLD

            def rank(r):
                with tmesh.use_mesh(views[r]):
                    model = copy.deepcopy(base)
                    opt = optim.DistributedOptimizer(
                        optim.SGD(model.parameters(), 0.0),
                        process_group=views[r].world_comm())
                    torch.nn.functional.mse_loss(model(xs[r]),
                                                 ys[r]).backward()
                    local = [p.grad.clone() for p in model.parameters()]
                    opt.step()
                    out[r] = (local, [p.grad for p in model.parameters()])
            if flag:
                setattr(cfg, flag, True)
            manager = tom.get_operation_manager()
            manager.selected.clear()
            try:
                threads = [threading.Thread(target=rank, args=(r,))
                           for r in range(WORLD)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in threads)
            finally:
                if flag:
                    setattr(cfg, flag, False)
            assert set(manager.selected) == {backend}
            for i in range(len(out[0][0])):
                mean = sum(o[0][i] for o in out) / WORLD
                for r in range(WORLD):
                    torch.testing.assert_close(
                        out[r][1][i], mean, rtol=0,
                        atol=1e-6 * mean.abs().max().item())
    finally:
        mpi_ops.shutdown()


def test_dropped_distributed_optimizer_frees_its_model():
    """The gradient hooks hold the optimizer weakly: autograd keeps them in
    C++ state, where a cycle back through the optimizer to the parameters
    is invisible to the garbage collector, so a strong hook kept every
    dropped model alive (phase 3g of chip_smoke.py builds twelve)."""
    import gc
    import weakref
    mpi_ops.init(device="cpu")
    try:
        views = tmesh.thread_meshes(tmesh.build_mesh(dp=2, devices=[0, 1]))
        model = _model()
        opt = optim.DistributedOptimizer(
            optim.SGD(model.parameters(), 0.1),
            process_group=views[0].world_comm())
        assert opt._hook_handles   # a world of 2: the hooks are registered
        ref = weakref.ref(model[0].weight)
        del model, opt
        gc.collect()
        assert ref() is None
    finally:
        mpi_ops.shutdown()
