"""horovod_tpu_torch's collectives, optimizer wrapper and broadcasts.

Two gloo ranks, spawned once for the whole module through
``torch.multiprocessing``, run every multi-worker check and report each
by name; the tests below read the reports. The semantics held are those
``tests/test_torch_frontend.py`` pins for the JAX package's torch
frontend (in-place variants return the submitted tensor, async ops
snapshot their input, stale handles and out-of-range roots raise,
compression restores the dtype, ``DistributedOptimizer`` averages
gradients and honours ``backward_passes_per_step``), here across two real
workers. Single-process cases run in this process on a one-worker gloo
group.
"""

import socket
import traceback

import pytest
import torch
import torch.multiprocessing as mp

from horovod_tpu_torch import mpi_ops, optim
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.ops.compression import Compression

WORLD = 2
JOIN_TIMEOUT_S = 180


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _model(seed):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                               torch.nn.Linear(8, 1))


def _gathered(x):
    """Every rank's ``x`` stacked along a new first axis."""
    return mpi_ops.allgather(x[None])


def _check_identity(r):
    assert mpi_ops.size() == WORLD and mpi_ops.rank() == r
    assert mpi_ops.process_count() == WORLD and mpi_ops.process_rank() == r
    assert mpi_ops.local_rank() == r and mpi_ops.local_size() == WORLD


def _check_allreduce(r):
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    base = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    torch.testing.assert_close(mpi_ops.allreduce(x), base + 5)
    torch.testing.assert_close(mpi_ops.allreduce(x, average=False),
                               2 * base + 10)
    y = x.clone()
    assert mpi_ops.allreduce_(y, average=False) is y
    torch.testing.assert_close(y, 2 * base + 10)
    ints = torch.tensor([1, 2, 3]) * (r + 1)
    torch.testing.assert_close(mpi_ops.allreduce(ints, average=False),
                               torch.tensor([3, 6, 9]))


def _check_async(r):
    x = torch.full((4,), 7.0 + r)
    h = mpi_ops.allreduce_async(x, average=False)
    x.zero_()   # the collective works on a snapshot
    out = mpi_ops.synchronize(h)
    torch.testing.assert_close(out, torch.full((4,), 15.0))
    h = mpi_ops.broadcast_async(torch.full((2,), float(r)), root_rank=1)
    while not mpi_ops.poll(h):
        pass
    torch.testing.assert_close(mpi_ops.synchronize(h), torch.ones(2))
    try:
        mpi_ops.synchronize(h)
    except ValueError as e:
        assert "already been synchronized" in str(e)
    else:
        raise AssertionError("a stale handle must raise")


def _check_grouped(r):
    tensors = [torch.full((10,), 1.0 + r), torch.full((20,), 2.0 + r),
               torch.full((3, 5), 3.0 + r, dtype=torch.float64),
               torch.arange(7) * (r + 1), torch.full((6,), 4.0 + r)]
    # 64 bytes: the fp32 tensors go in three buckets, fp64 and int alone
    buckets = fusion.plan_buckets(tensors, 64)
    assert len(buckets) >= 4, buckets
    out = mpi_ops.grouped_allreduce(tensors, average=False,
                                    fusion_threshold=64)
    want = [torch.full((10,), 3.0), torch.full((20,), 5.0),
            torch.full((3, 5), 7.0, dtype=torch.float64),
            torch.arange(7) * 3, torch.full((6,), 9.0)]
    for got, w in zip(out, want):
        assert got.dtype == w.dtype and got.shape == w.shape
        torch.testing.assert_close(got, w)
    avg = mpi_ops.grouped_allreduce(tensors[:2], fusion_threshold=0)
    torch.testing.assert_close(avg[1], torch.full((20,), 2.5))


def _check_allgather(r):
    x = torch.full((r + 1, 3), float(r))
    out = mpi_ops.allgather(x)
    torch.testing.assert_close(out, torch.tensor([[0.0] * 3, [1.0] * 3,
                                                  [1.0] * 3]))


def _check_broadcast(r):
    x = torch.full((5,), float(r + 1))
    torch.testing.assert_close(mpi_ops.broadcast(x, root_rank=1),
                               torch.full((5,), 2.0))
    torch.testing.assert_close(x, torch.full((5,), float(r + 1)))
    assert mpi_ops.broadcast_(x, root_rank=0) is x
    torch.testing.assert_close(x, torch.ones(5))
    for root in (WORLD, -1):
        try:
            mpi_ops.broadcast(x, root_rank=root)
        except ValueError as e:
            assert "root_rank" in str(e)
        else:
            raise AssertionError(f"root {root} must raise")


def _check_compression(r):
    x = torch.linspace(-1, 1, 16) * (r + 1)
    for codec in (Compression.fp16, Compression.bf16):
        out = mpi_ops.allreduce(x, compression=codec)
        assert out.dtype == torch.float32
        torch.testing.assert_close(out, torch.linspace(-1, 1, 16) * 1.5,
                                   rtol=1e-2, atol=1e-2)
    xb = x.to(torch.bfloat16)
    out = mpi_ops.allreduce(xb)
    assert out.dtype == torch.bfloat16
    assert Compression.from_name("bf16") is Compression.bf16


def _check_distributed_optimizer(r):
    model = _model(seed=r)   # ranks start apart
    optim.broadcast_parameters(model.state_dict(), root_rank=0)
    for p in model.parameters():
        g = _gathered(p.detach())
        torch.testing.assert_close(g[0], g[1], rtol=0, atol=0)
    opt = optim.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(), fusion_threshold=128)
    assert len(opt._buckets) > 1   # 4 tensors of 32-128 bytes
    torch.manual_seed(100 + r)
    X, Y = torch.randn(8, 4), torch.randn(8, 1)
    opt.zero_grad()
    torch.nn.functional.mse_loss(model(X), Y).backward()
    local = [p.grad.clone() for p in model.parameters()]
    opt.synchronize()
    for p, g in zip(model.parameters(), local):
        torch.testing.assert_close(p.grad, _gathered(g).mean(0))
    opt.step()
    for p in model.parameters():
        g = _gathered(p.detach())
        torch.testing.assert_close(g[0], g[1], rtol=0, atol=0)


def _check_backward_passes_per_step(r):
    model = _model(seed=0)
    opt = optim.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(),
        backward_passes_per_step=2, compression=Compression.none)
    torch.manual_seed(200 + r)
    opt.zero_grad()
    for i in range(2):
        torch.nn.functional.mse_loss(model(torch.randn(8, 4)),
                                     torch.randn(8, 1)).backward()
        assert bool(opt._handles) == (i == 1)   # fires on the 2nd pass
    # the allreduce was started from the hooks; step() joins it
    opt.step()
    assert not opt._handles and not opt._passes


def _check_backward_passes_local_sums(r):
    model = _model(seed=0)
    opt = optim.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.0),
        backward_passes_per_step=2)
    torch.manual_seed(300 + r)
    batches = [(torch.randn(8, 4), torch.randn(8, 1)) for _ in range(2)]
    ref = _model(seed=0)
    for X, Y in batches:
        torch.nn.functional.mse_loss(ref(X), Y).backward()
    opt.zero_grad()
    for X, Y in batches:
        torch.nn.functional.mse_loss(model(X), Y).backward()
    opt.synchronize()
    for p, q in zip(model.parameters(), ref.parameters()):
        torch.testing.assert_close(p.grad, _gathered(q.grad).mean(0))


def _check_broadcast_optimizer_state(r):
    model = _model(seed=0)
    base = optim.AdamW(model.parameters(), 1e-2, mu_dtype=torch.bfloat16)
    if r == 0:   # only the root has state, as after a checkpoint load
        model(torch.randn(4, 4)).sum().backward()
        base.step()
    optim.broadcast_optimizer_state(base, root_rank=0)
    state = base.state_dict()["state"]
    assert len(state) == 4
    for pid in sorted(state):
        for key in ("mu", "nu"):
            g = _gathered(state[pid][key].float())
            torch.testing.assert_close(g[0], g[1], rtol=0, atol=0)
        assert state[pid]["mu"].dtype == torch.bfloat16
    assert optim.broadcast_object({"epoch": 3 + r}, root_rank=1) == \
        {"epoch": 4}


CHECKS = {f.__name__[len("_check_"):]: f for f in (
    _check_identity, _check_allreduce, _check_async, _check_grouped,
    _check_allgather, _check_broadcast, _check_compression,
    _check_distributed_optimizer, _check_backward_passes_per_step,
    _check_backward_passes_local_sums, _check_broadcast_optimizer_state)}


def _worker(r, port, results):
    report = {}
    try:
        mpi_ops.init(device="cpu", rank=r, size=WORLD,
                     init_method=f"tcp://localhost:{port}")
        for name, check in CHECKS.items():
            try:
                check(r)
                report[name] = None
            except Exception:  # noqa: BLE001 — reported to the parent
                report[name] = traceback.format_exc()
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
    return got


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_two_gloo_ranks(reports, name):
    assert sorted(reports) == list(range(WORLD))
    for r in range(WORLD):
        assert "init" not in reports[r], reports[r]["init"]
        assert reports[r][name] is None, f"rank {r}:\n{reports[r][name]}"


@pytest.fixture
def one_worker():
    mpi_ops.init(device="cpu")
    yield mpi_ops
    mpi_ops.shutdown()


class TestOneWorker:
    def test_init_on_cpu_is_a_one_process_group(self, one_worker):
        assert one_worker.size() == 1 and one_worker.rank() == 0
        assert one_worker.is_initialized()
        from horovod_tpu_torch.common import state
        assert state.backend() == "gloo"
        assert state.device() == torch.device("cpu")
        x = torch.arange(4.0)
        torch.testing.assert_close(one_worker.allreduce(x), x)
        torch.testing.assert_close(one_worker.allgather(x[None])[0], x)

    def test_rejects_non_tensor(self, one_worker):
        with pytest.raises(ValueError, match="torch.Tensor"):
            one_worker.allreduce([1.0, 2.0])

    def test_duplicate_name_in_flight_raises(self, one_worker):
        from horovod_tpu_torch.common.exceptions import DuplicateNameError
        h = one_worker.allreduce_async(torch.ones(2), name="g")
        with pytest.raises(DuplicateNameError):
            one_worker.allreduce_async(torch.ones(2), name="g")
        one_worker.synchronize(h)

    def test_optimizer_guards(self, one_worker):
        model = _model(seed=0)
        opt = optim.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01),
            named_parameters=model.named_parameters())
        assert isinstance(opt, torch.optim.SGD)
        assert not opt._buckets   # no hooks on one worker
        opt._register_hooks()     # force them, as a multi-worker run has
        X, Y = torch.randn(8, 4), torch.randn(8, 1)
        torch.nn.functional.mse_loss(model(X), Y).backward()
        assert opt._handles
        with pytest.raises(AssertionError, match="zero_grad"):
            opt.zero_grad()
        with pytest.raises(ValueError, match="allreduced twice"):
            torch.nn.functional.mse_loss(model(X), Y).backward()
        opt.step()
        assert not opt._handles and not opt._passes

    def test_duplicate_named_parameters_rejected(self, one_worker):
        p = next(_model(seed=0).parameters())
        with pytest.raises(ValueError, match="duplicate"):
            optim.DistributedOptimizer(torch.optim.SGD([p], lr=0.1),
                                       named_parameters=[("a", p), ("a", p)])

    def test_not_ported_codecs_raise(self):
        for name in ("int8", "fp8"):
            with pytest.raises(NotImplementedError, match="not ported"):
                Compression.from_name(name)
        with pytest.raises(ValueError, match="unknown"):
            Compression.from_name("zip")


def test_init_raises_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mpi_ops.init()
    assert not mpi_ops.is_initialized()


def test_ops_before_init_raise():
    from horovod_tpu_torch.common.exceptions import NotInitializedError
    with pytest.raises(NotInitializedError):
        mpi_ops.size()
