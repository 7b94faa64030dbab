"""The port's ``trainer.instrument_step`` against the JAX package's, on
the CPU:

  * the same families and labels (``hvd_step_seconds``,
    ``hvd_steps_total``, ``hvd_tokens_per_second``), and, as in the
    reference off the accelerator, no ``hvd_mfu`` and no
    ``hvd_step_peak_hbm_bytes`` gauge on the CPU;
  * the compile tracker sees every call at site ``train:<name>``;
  * ``attrib_every=N`` captures every Nth step, never step 1, and
    publishes the busy fraction; a capture that fails emits
    ``perf_attrib_error`` and the step still returns its value;
  * planes off (``HVD_METRICS=0``, ``HVD_MEM=0``) hand back the step
    itself, and the tiny LM's parameters after three instrumented steps
    are bit-equal to three plain ones;
  * ``train_lm --steps`` runs its loop through it, and the per-axis wire
    attribution (``parallel.mesh.account_axis_bytes``) equals the JAX
    package's.
"""

import os

import numpy as np
import pytest
import torch

from horovod_tpu import trainer as jtrainer
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu.utils import memory as jmem
from horovod_tpu.utils import metrics as jm
from horovod_tpu_torch import trainer as ttrainer
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.utils import memory as tmem
from horovod_tpu_torch.utils import metrics as tm

# another test file in the same worker may leave HOROVOD_MESH* set, and
# train_lm.main with no layout flag builds its mesh from them
_MESH_ENV = ("HOROVOD_MESH", "HOROVOD_MESH_TP", "HOROVOD_MESH_SP",
             "HOROVOD_MESH_PP", "HOROVOD_MESH_EP")


@pytest.fixture(autouse=True, scope="module")
def _no_mesh_env():
    saved = {k: os.environ.pop(k) for k in _MESH_ENV if k in os.environ}
    yield
    os.environ.update(saved)


FAMILIES = ("hvd_step_seconds", "hvd_steps_total", "hvd_tokens_per_second",
            "hvd_mfu", "hvd_step_peak_hbm_bytes")


@pytest.fixture
def regs():
    out = (tm.reset(enabled=True), jm.reset(enabled=True))
    tmem.reset(enabled=True)
    jmem.reset(enabled=True)
    yield out
    for mod in (tm, jm, tmem, jmem):
        mod.reset()


def _labels(reg, name):
    fam = reg.snapshot()["metrics"].get(name)
    if fam is None:
        return None
    return sorted(tuple(sorted(v["labels"].items())) for v in fam["values"])


def test_families_equal_and_no_mfu_on_the_cpu(regs):
    treg, jreg = regs
    t = ttrainer.instrument_step(lambda x: x * 2, tokens_per_step=1024,
                                 name="unit", flops_per_token=6e6,
                                 device="cpu")
    j = jtrainer.instrument_step(lambda x: x * 2, tokens_per_step=1024,
                                 name="unit", flops_per_token=6e6)
    for i in range(3):
        assert torch.equal(t(torch.full((4,), float(i))),
                           torch.full((4,), 2.0 * i))
        j(np.full((4,), float(i), np.float32))
    for name in FAMILIES:
        assert _labels(treg, name) == _labels(jreg, name), name
    snap = treg.snapshot()["metrics"]
    assert "hvd_mfu" not in snap and "hvd_step_peak_hbm_bytes" not in snap
    assert snap["hvd_steps_total"]["values"][0]["value"] == 3.0
    assert snap["hvd_step_seconds"]["values"][0]["count"] == 3
    assert snap["hvd_tokens_per_second"]["values"][0]["value"] > 0
    site = tmem.get_tracker().site_summary()["train:unit"]
    assert (site["hits"], site["misses"]) == (2, 1)


def test_attribution_every_nth_step_and_a_failing_capture(regs,
                                                          monkeypatch):
    treg, _ = regs
    calls = []
    t = ttrainer.instrument_step(lambda x: calls.append(x) or x,
                                 name="attr", attrib_every=2, device="cpu")
    for i in range(5):
        t(i)
    assert calls == list(range(5))
    snap = treg.snapshot()["metrics"]
    # steps 2 and 4 were captured; no device event on the CPU
    assert snap["hvd_step_device_busy_frac"]["values"][0]["value"] == 0.0
    assert t.last_decomposition["device_ms_per_step"] == 0.0
    assert (t.last_decomposition["launch_calls"],
            t.last_decomposition["unrecorded_launches"]) == (0, 0)
    assert not [e for e in treg.events()
                if e["event"] == "perf_attrib_error"]

    from horovod_tpu_torch.utils import profiling

    def boom(*a, **k):
        raise RuntimeError("no trace")
    monkeypatch.setattr(profiling, "profile_decomposition", boom)
    t2 = ttrainer.instrument_step(lambda x: x + 1, name="attr2",
                                  attrib_every=2, device="cpu")
    assert [t2(i) for i in range(4)] == [1, 2, 3, 4]
    errs = [e for e in treg.events() if e["event"] == "perf_attrib_error"]
    assert [e["phase"] for e in errs] == ["attribute", "attribute"]

    import torch.profiler as tprof

    class Broken:
        def __init__(self, *a, **k):
            raise RuntimeError("profiler busy")
    monkeypatch.setattr(tprof, "profile", Broken)
    t3 = ttrainer.instrument_step(lambda x: x, name="attr3",
                                  attrib_every=1, device="cpu")
    assert [t3(i) for i in range(3)] == [0, 1, 2]
    errs = [e for e in treg.events() if e["event"] == "perf_attrib_error"
            and e["phase"] == "start"]
    assert len(errs) == 2        # steps 2 and 3: never step 1


def _tiny_step(seed=0):
    from horovod_tpu_torch import optim
    from horovod_tpu_torch.models import transformer as tr
    cfg = tr.TransformerConfig.tiny(dtype=torch.float32,
                                    attention_impl="full")
    model = tr.init_params(cfg, torch.Generator().manual_seed(seed),
                           device="cpu", train=True)
    opt = optim.AdamW(model.parameters(), 3e-4)
    step = ttrainer.make_train_step(model, opt, tr.lm_loss_fn(model))
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (3, 2, 16)))
    return model, step, toks


def test_planes_off_leave_the_step_bit_equal(monkeypatch):
    tm.reset(enabled=True)
    tmem.reset(enabled=True)
    try:
        model_on, step_on, toks = _tiny_step()
        timed = ttrainer.instrument_step(step_on, tokens_per_step=32,
                                         name="lm", device="cpu")
        for i in range(3):
            timed(toks[i])
    finally:
        tm.reset()
        tmem.reset()
    monkeypatch.setenv("HVD_METRICS", "0")
    monkeypatch.setenv("HVD_MEM", "0")
    tm.reset()
    tmem.reset()
    model_off, step_off, toks = _tiny_step()
    plain = ttrainer.instrument_step(step_off, name="lm", device="cpu")
    assert plain is step_off
    for i in range(3):
        plain(toks[i])
    for a, b in zip(model_on.parameters(), model_off.parameters()):
        assert torch.equal(a, b)
    tm.reset()
    tmem.reset()


def test_axis_bytes_equal_the_jax_accounting(regs):
    treg, jreg = regs
    for axis, nbytes in (("dp", 607_600_000), ("tp", 12_582_912),
                         ("dp", 1)):
        tmesh.account_axis_bytes(axis, nbytes)
        jmesh.account_axis_bytes(axis, nbytes)
    for name in ("hvd_wire_bytes_total", "hvd_wire_raw_bytes_total"):
        t = treg.snapshot()["metrics"][name]["values"]
        j = jreg.snapshot()["metrics"][name]["values"]
        assert sorted(map(str, t)) == sorted(map(str, j))


def test_train_lm_steps_loop_is_instrumented():
    from horovod_tpu_torch import train_lm
    reg = tm.reset(enabled=True)
    tmem.reset(enabled=True)
    try:
        out = train_lm.main(["--device", "cpu", "--steps", "3"])
        assert len(out["losses"]) == 3
        snap = reg.snapshot()["metrics"]
        steps = [v for v in snap["hvd_steps_total"]["values"]
                 if v["labels"] == {"loop": "train_lm"}]
        assert steps[0]["value"] == 3.0
        assert "hvd_mfu" not in snap
        site = tmem.get_tracker().site_summary()["train:train_lm"]
        assert site["hits"] + site["misses"] == 3
    finally:
        tm.reset()
        tmem.reset()


def test_axis_wire_bytes_of_the_loop():
    from horovod_tpu_torch import train_lm
    from horovod_tpu_torch.models import transformer as tr

    class M:
        def __init__(self, **shape):
            self.shape = shape
    cfg = tr.TransformerConfig.tiny()
    model = tr.TransformerLM(cfg, torch.device("meta"), torch.float32)
    total = sum(p.numel() * 4 for p in model.parameters())
    orig = tmesh.mesh_axis_size
    try:
        tmesh.mesh_axis_size = lambda m, a: m.shape.get(a, 1)
        assert train_lm.axis_wire_bytes(cfg, model, M(dp=1, tp=1), 8,
                                        64) == (0, 0)
        assert train_lm.axis_wire_bytes(cfg, model, M(dp=2, tp=2), 8,
                                        64) == (
            total, 4 * cfg.num_layers * 4 * 64 * cfg.d_model * 2)
    finally:
        tmesh.mesh_axis_size = orig
