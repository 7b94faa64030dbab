"""horovod_tpu_torch's eager coordination core (``ops/eager.py``) against
the JAX package's.

On one rank: the local plan fuses a burst into the buckets
``plan_buckets`` predicts and the plan cache serves repeats; duplicate
names raise; callbacks fire at completion; the timeline holds the
NEGOTIATE and ALLREDUCE spans; ``HOROVOD_AUTOTUNE`` and unknown codecs
are refused (the quantized ones run: tests/test_torch_port_quantization.py);
and the stall cases of ``tests/test_stall.py`` (the metrics gauge aside,
which comes with slice 8): the warning after the check time, once per
tensor, the StalledError at the shutdown deadline from ``synchronize``
and from the background scan, and the shutdown failing pending handles.

The JAX eager core runs on 2 virtual CPU devices (``init(devices=
jax.devices()[:2])``): its stacked row i is port rank i. Two gloo ranks,
spawned once for the module with ``HVD_SECRET_KEY`` set, run the port's
eager collectives and the eager steps of ``trainer`` on the same seeded
inputs: allreduce (sum and average), the ragged allgather, broadcast,
reducescatter and alltoall against the JAX core's results; and two
steps of ``build_eager_lm_step``'s recipe on ``TransformerConfig.tiny``
(full attention: the flash walks are held to JAX elsewhere; AdamW(3e-4,
mu bf16)) and of ``build_eager_image_step``'s on ResNet-18 at 32 × 32
(SGD(momentum 0.9) at ``VISION_LR``) against the JAX harness's recipe
(``examples/bench_common.py:_eager_step``): the averaged gradients of
the first step and the parameters after the second (LM: rtol 1e-4 /
atol 1e-5, tests/test_torch_port_train.py's; vision gradients: 1e-4 of
each gradient's largest magnitude, tests/test_torch_port_vision_train.py's;
vision parameters: their change over the two steps, see the test).
"""

import base64
import json
import logging
import os
import socket
import sys
import time
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from horovod_tpu_torch import mpi_ops, optim, trainer
from horovod_tpu_torch.common import state as state_mod
from horovod_tpu_torch.common.exceptions import (DuplicateNameError,
                                                 ShutdownError, StalledError)
from horovod_tpu_torch.ops import fusion as tfusion

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
JOIN_TIMEOUT_S = 150
LM_BATCH, LM_SEQ = 2, 32
VISION_BATCH, VISION_SIZE = 8, 32
# the recipe's SGD(0.01) takes this model's loss from 3.5 to under 1.5
# in one step, where the JAX package's own jitted and eager steps already
# differ by more than the tolerance below after two steps; at 1e-4 they
# agree well within it, so two steps can be compared
VISION_LR = 1e-4


def _coord():
    return state_mod.global_state().coordinator


@pytest.fixture
def core():
    mpi_ops.init(device="cpu")
    yield _coord()
    mpi_ops.shutdown()


# ---------------------------------------------------------------------------
# one rank


def test_burst_fuses_into_the_predicted_buckets(core, monkeypatch):
    monkeypatch.setattr(core._config, "fusion_threshold", 4096)
    r = np.random.RandomState(0)
    tensors = [torch.from_numpy(r.randint(-9, 9, n)).to(dt)
               for n, dt in zip(r.randint(1, 700, 64),
                                [torch.float32, torch.bfloat16,
                                 torch.int32, torch.float32] * 16)]
    want = sum(len(tfusion.plan_buckets(
        [t for t in tensors if t.dtype == dt], 4096))
        for dt in (torch.float32, torch.bfloat16, torch.int32))
    before = core.executed_groups
    with core.hold_cycle():
        handles = mpi_ops.grouped_allreduce_async(tensors, average=False)
    outs = [mpi_ops.synchronize(h) for h in handles]
    assert core.executed_groups - before == want
    for t, o in zip(tensors, outs):
        assert o.dtype == t.dtype and torch.equal(o, t)   # world 1: exact


def test_plan_cache_serves_a_repeated_batch(core):
    xs = [torch.ones(3), torch.ones(5)]
    for _ in range(3):
        with core.hold_cycle():
            hs = mpi_ops.grouped_allreduce_async(xs, name="rep")
        [mpi_ops.synchronize(h) for h in hs]
    assert core.plan_cache.hits >= 2


def test_duplicate_name_raises(core):
    with core.hold_cycle():
        h = mpi_ops.allreduce_async(torch.ones(2), name="dup")
        with pytest.raises(DuplicateNameError):
            mpi_ops.allreduce_async(torch.ones(2), name="dup")
        with pytest.raises(DuplicateNameError):
            core.enqueue_group([("d2", "allreduce", torch.ones(1), 0, False,
                                 None)] * 2)
    mpi_ops.synchronize(h)
    mpi_ops.synchronize(mpi_ops.allreduce_async(torch.ones(2), name="dup"))


def test_callbacks_fire_at_completion(core):
    seen = []
    h = core.enqueue("cb", "allreduce", torch.full((2,), 3.0),
                     callback=lambda e: seen.append((e.name, e.status)))
    out = core.synchronize(h)
    assert seen == [("cb", True)] and out.tolist() == [3.0, 3.0]


def test_poll_and_in_place_variants(core):
    x = torch.arange(4.0)
    with core.hold_cycle():
        h = mpi_ops.allreduce_async_(x, average=True, name="inplace")
        assert not mpi_ops.poll(h)
    assert mpi_ops.synchronize(h) is x
    b = torch.zeros(3)
    assert mpi_ops.broadcast_(b, 0) is b


def test_concurrent_enqueues_from_many_threads(core):
    """More threads than cores enqueue and synchronize at once under a
    shortened switch interval: every result is its input and the tensor
    table drains."""
    import threading
    n_threads, per_thread = 4 * (os.cpu_count() or 4), 8
    errors = []

    def worker(t):
        try:
            for i in range(per_thread):
                x = torch.full((3,), float(t * 100 + i))
                out = mpi_ops.allreduce(x, average=False,
                                        name=f"thr{t}.{i}")
                if not torch.equal(out, x):
                    errors.append((t, i, out))
        except Exception as exc:  # noqa: BLE001 — asserted below
            errors.append((t, exc))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert core._tensor_table == {}


def test_timeline_holds_negotiate_and_allreduce_spans(tmp_path,
                                                      monkeypatch):
    path = str(tmp_path / "timeline.json")
    monkeypatch.setenv("HOROVOD_TIMELINE", path)
    monkeypatch.setenv("HOROVOD_TIMELINE_MARK_CYCLES", "1")
    mpi_ops.init(device="cpu")
    try:
        mpi_ops.grouped_allreduce([torch.ones(4), torch.ones(2)])
        mpi_ops.allgather(torch.ones(2, 2), name="ag")
    finally:
        mpi_ops.shutdown()
    names = {e.get("name") for e in json.load(open(path))}
    assert {"NEGOTIATE_ALLREDUCE", "ALLREDUCE", "MEMCPY_IN_FUSION_BUFFER",
            "NEGOTIATE_ALLGATHER", "ALLGATHER", "CYCLE_START"} <= names


@pytest.mark.parametrize("var,value,err", [
    ("HOROVOD_AUTOTUNE", "1", NotImplementedError),
    ("HOROVOD_COMPRESSION", "zstd", ValueError)])
def test_init_refuses_what_is_not_ported(monkeypatch, var, value, err):
    monkeypatch.setenv(var, value)
    with pytest.raises(err):
        mpi_ops.init(device="cpu")
    assert not mpi_ops.is_initialized()


def test_cast_codec_sums_in_the_wire_dtype(monkeypatch):
    """HOROVOD_COMPRESSION=bf16: a float tensor of at least 1024 bytes is
    summed in bf16 and handed back in its own dtype."""
    monkeypatch.setenv("HOROVOD_COMPRESSION", "bf16")
    mpi_ops.init(device="cpu")
    try:
        x = torch.full((512,), 1.0 + 2 ** -12)
        out = mpi_ops.allreduce(x, average=False)
        assert out.dtype == torch.float32
        assert torch.equal(out, torch.ones(512))   # rounded through bf16
        small = torch.full((4,), 1.0 + 2 ** -12)
        assert torch.equal(mpi_ops.allreduce(small), small)
    finally:
        mpi_ops.shutdown()


# -- stalls (tests/test_stall.py) --


@pytest.fixture
def stall_core(monkeypatch):
    monkeypatch.setenv("HOROVOD_STALL_CHECK_TIME_SECONDS", "0.15")
    monkeypatch.setenv("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", "0.8")
    mpi_ops.init(device="cpu")
    yield _coord()
    mpi_ops.shutdown()


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def records():
    from horovod_tpu_torch.common import hvd_logging
    handler = _Records()
    hvd_logging.get_logger().addHandler(handler)
    yield handler.messages
    hvd_logging.get_logger().removeHandler(handler)


class TestStall:
    def test_stall_warns_after_check_time(self, stall_core, records):
        stall_core._paused = True
        try:
            h = mpi_ops.allreduce_async(torch.ones(8, 2), name="slow")
            time.sleep(0.3)
            stall_core._check_stalled()
            assert any("slow" in m and "subset of ranks" in m
                       for m in records)
            # warned, not killed: releasing the flush completes it
            stall_core._paused = False
            torch.testing.assert_close(mpi_ops.synchronize(h),
                                       torch.ones(8, 2))
        finally:
            stall_core._paused = False

    def test_stall_warning_emitted_once_per_tensor(self, stall_core,
                                                   records):
        stall_core._paused = True
        try:
            h = mpi_ops.allreduce_async(torch.ones(8, 1), name="once")
            time.sleep(0.3)
            stall_core._check_stalled()
            stall_core._check_stalled()
            assert sum("once" in m for m in records) == 1
            stall_core._paused = False
            mpi_ops.synchronize(h)
        finally:
            stall_core._paused = False

    def test_synchronize_raises_after_shutdown_deadline(self, stall_core):
        stall_core._paused = True
        try:
            h = mpi_ops.allreduce_async(torch.ones(8, 1), name="dead")
            with pytest.raises(StalledError, match="dead"):
                mpi_ops.synchronize(h)
        finally:
            stall_core._paused = False

    def test_background_kill_marks_entry_stalled(self, stall_core):
        stall_core._paused = True
        try:
            h = mpi_ops.allreduce_async(torch.ones(8, 1), name="killed")
            time.sleep(0.9)
            stall_core._check_stalled()
            assert "killed" not in stall_core._tensor_table
            with pytest.raises(StalledError, match="killed"):
                mpi_ops.synchronize(h)
        finally:
            stall_core._paused = False

    def test_stall_error_names_every_killed_tensor(self, stall_core):
        stall_core._paused = True
        try:
            hs = [mpi_ops.allreduce_async(torch.ones(2), name=n)
                  for n in ("first", "second")]
            time.sleep(0.9)
            stall_core._check_stalled()
            for h in hs:
                with pytest.raises(StalledError,
                                   match="first, second"):
                    mpi_ops.synchronize(h)
        finally:
            stall_core._paused = False

    def test_shutdown_fails_pending_handles(self, stall_core):
        stall_core._paused = True
        h = mpi_ops.allreduce_async(torch.ones(8, 1), name="pending")
        ch = stall_core.enqueue("pending.core", "allreduce", torch.ones(2))
        mpi_ops.shutdown()
        with pytest.raises((ShutdownError, mpi_ops.NotInitializedError)):
            mpi_ops.synchronize(h)
        with pytest.raises(ShutdownError):
            stall_core.synchronize(ch)


# ---------------------------------------------------------------------------
# two ranks against the JAX eager core on 2 virtual devices


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _inputs(r):
    """Rank r's seeded collective inputs (JAX's stacked row r)."""
    g = np.random.RandomState(100 + r)
    return {"ar": g.randn(5, 3).astype(np.float32),
            "ints": g.randint(-50, 50, (7,)).astype(np.int32),
            "ag": g.randn(2 + r, 3).astype(np.float32),
            "bc": g.randn(4).astype(np.float32),
            "rs": g.randn(4, 3).astype(np.float32),
            "a2a": g.randn(4, 2).astype(np.float32)}


def _collectives(r, arrays):
    x = {k: torch.from_numpy(v) for k, v in _inputs(r).items()}
    return {
        "sum": mpi_ops.allreduce(x["ar"], average=False).numpy(),
        "mean": mpi_ops.allreduce(x["ar"], average=True).numpy(),
        "ints": mpi_ops.allreduce(x["ints"], average=False).numpy(),
        "ag": mpi_ops.allgather(x["ag"]).numpy(),
        "bc": mpi_ops.broadcast(x["bc"], root_rank=1).numpy(),
        "rs": mpi_ops.reducescatter(x["rs"]).numpy(),
        "a2a": mpi_ops.alltoall(x["a2a"]).numpy()}


def _lm_step(r, arrays):
    from horovod_tpu_torch.models import transformer as ttr
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32,
                                     attention_impl="full")
    model = ttr.init_params(cfg, device="cpu", train=True)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in arrays["lm"].items()})
    opt = optim.AdamW(model.parameters(), 3e-4, mu_dtype=torch.bfloat16)
    step = trainer.make_eager_step(model, opt, ttr.lm_loss_fn(model))
    toks = torch.from_numpy(arrays["lm_tokens"][:, r]).long()
    return _two_steps(model, step, [toks[0], toks[1]])


def _vision_step(r, arrays):
    from horovod_tpu_torch import models
    model = models.build("resnet18", num_classes=10, dtype=torch.float32,
                         device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in arrays["vision"].items()})
    model.train()
    opt = optim.SGD(model.parameters(), VISION_LR, momentum=0.9)

    def loss_fn(model, batch):
        return trainer.softmax_cross_entropy(model(batch[0]), batch[1])

    step = trainer.make_eager_step(model, opt, loss_fn)
    imgs = torch.from_numpy(np.ascontiguousarray(
        arrays["images"][r].transpose(0, 3, 1, 2))).contiguous(
        memory_format=torch.channels_last)
    lbls = torch.from_numpy(arrays["labels"][r]).long()
    return _two_steps(model, step, [(imgs, lbls)] * 2)


def _two_steps(model, step, batches):
    losses = [step(batches[0]).item()]
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    losses.append(step(batches[1]).item())
    params = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters()}
    return {"losses": losses, "grads": grads, "params": params}


JOBS = ("collectives", "lm_step", "vision_step")


def _worker(r, port, cport, arrays, results):
    torch.set_num_threads(1)
    os.environ["HVD_CONTROL_ADDR"] = f"localhost:{cport}"
    os.environ["HVD_SECRET_KEY"] = base64.b64encode(b"e" * 32).decode()
    report = {}
    try:
        mpi_ops.init(device="cpu", rank=r, size=WORLD,
                     init_method=f"tcp://localhost:{port}")
        for name in JOBS:
            try:
                report[name] = globals()["_" + name](r, arrays)
            except Exception:  # noqa: BLE001 — reported to the parent
                report[name] = traceback.format_exc()
        report["negotiated"] = _coord().negotiated
        mpi_ops.shutdown()
    except Exception:  # noqa: BLE001
        report["init"] = traceback.format_exc()
    results.put((r, report))


# -- the JAX side


def _jax_lm():
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtr
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.models.convert import params_from_flax
    jcfg = jtr.TransformerConfig.tiny(dtype=jnp.float32,
                                      attention_impl="full")
    _, params = jtr.init_params(jcfg, jax.random.PRNGKey(3),
                                seq_len=LM_SEQ)
    tcfg = ttr.TransformerConfig.tiny(dtype=torch.float32,
                                      attention_impl="full")
    model = params_from_flax(jax.device_get(params), tcfg, device="cpu",
                             train=True)
    tokens = np.random.RandomState(5).randint(
        0, 256, (2, WORLD, LM_BATCH, LM_SEQ)).astype(np.int32)
    return jcfg, params, model, tokens


def _jax_vision():
    import jax
    import jax.numpy as jnp
    from horovod_tpu import models as jmodels
    from horovod_tpu_torch.models.convert import vision_from_flax
    from test_torch_port_vision import _port, _random_variables
    jmodel = jmodels.build("resnet18", num_classes=10, dtype=jnp.float32)
    variables = _random_variables(
        jmodel, (VISION_BATCH, VISION_SIZE, VISION_SIZE, 3), seed=21)
    model = vision_from_flax(variables, _port("resnet18"))
    g = np.random.RandomState(22)
    images = g.randn(WORLD, VISION_BATCH, VISION_SIZE, VISION_SIZE,
                     3).astype(np.float32)
    labels = g.randint(0, 10, (WORLD, VISION_BATCH)).astype(np.int32)
    return jmodel, variables, model, images, labels


@pytest.fixture(scope="module")
def setup():
    jlm = _jax_lm()
    jvision = _jax_vision()
    arrays = {
        "lm": {k: v.detach().numpy() for k, v in
               jlm[2].state_dict().items()},
        "lm_tokens": jlm[3],
        "vision": {k: v.detach().numpy() for k, v in
                   jvision[2].state_dict().items()},
        "images": jvision[3], "labels": jvision[4]}
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port, cport = _free_port(), _free_port()
    procs = [ctx.Process(target=_worker,
                         args=(r, port, cport, arrays, results))
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
    return got, jlm, jvision


def _report(setup, name):
    got = setup[0]
    for r in range(WORLD):
        assert not isinstance(got[r][name], str), \
            f"rank {r}:\n{got[r][name]}"
    return [got[r][name] for r in range(WORLD)]


@pytest.fixture
def jhvd():
    import jax
    import horovod_tpu as jax_hvd
    jax_hvd.init(devices=jax.devices()[:WORLD])
    assert jax_hvd.size() == WORLD
    yield jax_hvd
    jax_hvd.shutdown()


@pytest.mark.parametrize("op", ["sum", "mean", "ints", "ag", "bc", "rs",
                                "a2a"])
def test_collectives_match_the_jax_core(setup, jhvd, op):
    import jax.numpy as jnp
    stacked = {k: np.stack([_inputs(r)[k] for r in range(WORLD)])
               for k in ("ar", "ints", "bc", "rs", "a2a")}
    want = {
        "sum": lambda: jhvd.allreduce(jnp.asarray(stacked["ar"]),
                                      average=False),
        "mean": lambda: jhvd.allreduce(jnp.asarray(stacked["ar"])),
        "ints": lambda: jhvd.allreduce(jnp.asarray(stacked["ints"]),
                                       average=False),
        "ag": lambda: jhvd.allgather(
            [jnp.asarray(_inputs(r)["ag"]) for r in range(WORLD)]),
        "bc": lambda: jhvd.broadcast(jnp.asarray(stacked["bc"]),
                                     root_rank=1),
        "rs": lambda: jhvd.reducescatter(jnp.asarray(stacked["rs"])),
        "a2a": lambda: jhvd.alltoall(jnp.asarray(stacked["a2a"]))}[op]()
    want = np.asarray(want)
    for r, got in enumerate(_report(setup, "collectives")):
        w = want if op == "ag" else want[r]
        if op == "ints":
            np.testing.assert_array_equal(got[op], w)
        else:
            np.testing.assert_allclose(got[op], w, rtol=1e-6, atol=1e-6)


def _bench_common():
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import bench_common
    finally:
        sys.path.pop(0)
    return bench_common


def test_lm_eager_step_matches_jax(setup, jhvd):
    """Two steps of the tiny LM at 2 ranks against the JAX harness's
    ``_eager_step`` on the stacked shards: the first step's averaged
    gradients and the parameters after the second."""
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu.models import transformer as jtr
    from test_torch_port_train import _flax_path, _leaf
    jcfg, params, _, tokens = setup[1]
    loss_fn = jtr.lm_loss_fn(jtr.TransformerLM(jcfg))
    tx = optax.adamw(3e-4, mu_dtype=jnp.bfloat16)
    grad_fn = jax.vmap(jax.value_and_grad(loss_fn), in_axes=(None, 0))
    losses, grads = grad_fn(params, jnp.asarray(tokens[0]))
    jgrads = jax.device_get(jax.tree_util.tree_map(
        lambda g: g[0], jhvd.allreduce_gradients(grads)))
    step = _bench_common()._eager_step(loss_fn, tx)
    state = tx.init(params)
    jp = params
    for i in range(2):
        jp, state, _ = step(jp, state, jnp.asarray(tokens[i]))
    jp = jax.device_get(jp)
    for r, got in enumerate(_report(setup, "lm_step")):
        np.testing.assert_allclose(got["losses"][0], float(losses[r]),
                                   rtol=1e-5)
        for name in got["grads"]:
            path, transposed = _flax_path(name)
            for have, tree in ((got["grads"], jgrads),
                               (got["params"], jp)):
                a = have[name]
                np.testing.assert_allclose(
                    a.T if transposed else a, _leaf(tree, path), rtol=1e-4,
                    atol=1e-5, err_msg=f"rank {r} {name}")


def test_vision_eager_step_matches_jax(setup, jhvd):
    """Two steps of ResNet-18 at 32 × 32 (batch 8 a rank) against the
    JAX recipe of ``_eager_step`` with ``optax.sgd(VISION_LR,
    momentum=0.9)``: the first step's gradients averaged by the JAX eager
    core, and the parameters after the second step of the recipe, its
    average the mean of the stacked rows (the harness's ``_eager_step``
    itself jits the gradient, see below). The change of each parameter
    over the two steps: rtol 1e-4, and 1e-4 of the change's largest
    magnitude plus two fp32 roundings of the parameter's; the change is
    held to be more than ten times that, so a step that moved nothing
    fails."""
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu import trainer as jtrainer
    from test_torch_port_vision_train import _flax_leaf
    jmodel, variables, _, images, labels = setup[2]
    params, stats = variables["params"], variables["batch_stats"]

    def loss_fn(p, batch):
        imgs, lbls = batch
        logits, _ = jmodel.apply({"params": p, "batch_stats": stats}, imgs,
                                 train=True, mutable=["batch_stats"])
        return jtrainer.softmax_cross_entropy(logits, lbls)

    tx = optax.sgd(VISION_LR, momentum=0.9)
    batch = (jnp.asarray(images), jnp.asarray(labels))
    # not jitted: XLA's fusions of the BatchNorm backward move this
    # model's gradients by more than the tolerance; the eager JAX ops are
    # the ones the port's vision tests hold it to
    grad_fn = jax.vmap(jax.value_and_grad(loss_fn), in_axes=(None, 0))
    state = tx.init(params)
    jp = params
    for i in range(2):
        _, grads = grad_fn(jp, batch)
        if i == 0:
            jgrads = jax.device_get(jax.tree_util.tree_map(
                lambda g: g[0], jhvd.allreduce_gradients(grads)))
        mean = jax.tree_util.tree_map(lambda g: g.mean(0), grads)
        updates, state = tx.update(mean, state, jp)
        jp = optax.apply_updates(jp, updates)
    jp = jax.device_get(jp)
    for r, got in enumerate(_report(setup, "vision_step")):
        for name, g in got["grads"].items():
            want = _flax_leaf(jgrads, name)
            np.testing.assert_allclose(g, want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=f"rank {r} {name}")
            # the change over two steps: the gradients' 1e-4 carried
            # into it, plus one fp32 rounding of each stored parameter
            p0 = _flax_leaf(params, name)
            want = _flax_leaf(jp, name) - p0
            atol = (1e-4 * np.abs(want).max() +
                    2 * np.finfo(np.float32).eps * np.abs(p0).max())
            # a step that left the parameters alone would fail
            assert np.abs(want).max() > 10 * atol, name
            np.testing.assert_allclose(
                got["params"][name] - p0, want, rtol=1e-4, atol=atol,
                err_msg=f"rank {r} {name}")


def test_eager_step_refuses_a_distributed_optimizer(core):
    model = torch.nn.Linear(3, 2)
    opt = optim.DistributedOptimizer(optim.SGD(model.parameters(), 0.1))
    with pytest.raises(ValueError, match="averages the gradients"):
        trainer.make_eager_step(model, opt, lambda m, b: m(b).sum())


def test_distributed_grad_averages_through_the_core(core):
    def loss(w, x):
        return ((w * x) ** 2).sum()
    w, x = torch.ones(3), torch.arange(3.0)
    g = optim.distributed_grad(loss)(w, x)
    torch.testing.assert_close(g, 2 * w * x * x)
    g2, aux = optim.distributed_grad(
        lambda w: (loss(w, x), torch.tensor(7.0)), has_aux=True)(w)
    assert aux.item() == 7.0
    torch.testing.assert_close(g2, g)


def test_eager_step_entry_points_build_on_one_rank(core):
    step, model, opt, toks = trainer.build_eager_lm_step(
        __import__("horovod_tpu_torch.models.transformer",
                   fromlist=["x"]).TransformerConfig.tiny(
            attention_impl="full"), 2, 16, "cpu", inner=2)
    assert toks.shape == (2, 2, 16)
    first = step(toks[0]).item()
    assert np.isfinite(first)
    assert not optim.averages_gradients(opt)
