"""The port's memory & compile plane (``horovod_tpu_torch/utils/memory.py``)
against the JAX package's (``horovod_tpu/utils/memory.py``) on the CPU:

  * ``tree_per_chip_bytes`` and ``plan_memory`` on dp2×tp2 specs, equal to
    the byte (the port's planner builds the model on ``meta``, the JAX
    one runs ``eval_shape``);
  * ``CompileTracker`` fed the same key sequence: outcomes, site
    summaries, the storm ladder's counter, event and flight dump;
  * ``abstract_key`` / ``format_key`` strings;
  * the ledger's snapshot and gauges, and the flight-dump section;
  * the device probes are None on the CPU, as the reference's are.

The reference test ``test_memory.py::TestReshardingSentinel::
test_mis_specced_jit_names_leaf_and_axis`` fails on the reference side,
so nothing here takes its output as ground truth.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from horovod_tpu.models import transformer as jtr
from horovod_tpu.utils import memory as jmem
from horovod_tpu.utils import metrics as jmetrics
from horovod_tpu.utils import tracing as jtracing
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.parallel.mesh import P as TP
from horovod_tpu_torch.utils import memory as tmem
from horovod_tpu_torch.utils import metrics as tmetrics
from horovod_tpu_torch.utils import tracing as ttracing

LAYOUT = {"dp": 2, "tp": 2}


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_FLIGHT_DIR", str(tmp_path))
    for mem, met, tr in ((tmem, tmetrics, ttracing),
                         (jmem, jmetrics, jtracing)):
        mem.reset(enabled=True)
        met.reset(enabled=True)
        tr.reset(enabled=True)
    yield
    for mem, met, tr in ((tmem, tmetrics, ttracing),
                         (jmem, jmetrics, jtracing)):
        mem.reset()
        met.reset()
        tr.reset()


SHAPES = {"w_qkv": ((16, 48), "float32", ("tp", None)),
          "w_out": ((16, 16), "float32", (None, "tp")),
          "emb": ((64, 16), "bfloat16", ("tp", None)),
          "odd": ((3, 5), "float32", ("tp", None)),   # indivisible: whole
          "scale": ((16,), "float32", ())}


def _trees():
    jt = {k: jax.ShapeDtypeStruct(s, jnp.dtype(d))
          for k, (s, d, _) in SHAPES.items()}
    js = {k: JP(*p) for k, (_, _, p) in SHAPES.items()}
    tt = {k: torch.empty(s, dtype=getattr(torch, d), device="meta")
          for k, (s, d, _) in SHAPES.items()}
    ts = {k: TP(*p) for k, (_, _, p) in SHAPES.items()}
    return jt, js, tt, ts


@pytest.mark.parametrize("layout", [{"dp": 2, "tp": 2}, {"dp": 1, "tp": 4},
                                    {"dp": 4, "tp": 1}])
def test_tree_per_chip_bytes_equal(layout):
    jt, js, tt, ts = _trees()
    want = jmem.tree_per_chip_bytes(jt, js, jmem._PlanMesh(layout))
    assert tmem.tree_per_chip_bytes(tt, ts, layout) == want
    # without specs: whole tensors, as the JAX package's concrete arrays
    conc = {k: jnp.zeros(s, jnp.dtype(d)) for k, (s, d, _) in SHAPES.items()}
    assert tmem.tree_per_chip_bytes(
        {k: torch.zeros(s, dtype=getattr(torch, d))
         for k, (s, d, _) in SHAPES.items()}) == \
        jmem.tree_per_chip_bytes(conc)


@pytest.mark.parametrize("name", ["tiny", "gpt2_small_tpu"])
@pytest.mark.parametrize("kw", [
    dict(dp=2, tp=2, batch_per_chip=4, seq=64),
    dict(dp=2, tp=2, batch_per_chip=16, seq=1024, optimizer="sgd",
         kv_slots=4, kv_max_len=256),
    dict(dp=1, tp=1, sp=2, batch_per_chip=2, seq=128, optimizer="none")])
def test_plan_memory_equal_to_the_byte(name, kw):
    jc = getattr(jtr.TransformerConfig, name)(tie_embeddings=True)
    tc = getattr(ttr.TransformerConfig, name)(tie_embeddings=True)
    want = jmem.plan_memory(jc, chip="cpu", **kw)
    got = tmem.plan_memory(tc, chip="cpu", **kw)
    assert got == want


def test_plan_verdict_on_an_h100():
    tc = ttr.TransformerConfig.gpt2_small_tpu()
    plan = tmem.plan_memory(tc, dp=2, tp=4, batch_per_chip=16, seq=1024,
                            chip="NVIDIA H100 80GB HBM3")
    assert plan["chip"] == "NVIDIA H100 80GB HBM3"
    assert plan["capacity_bytes"] == 80 * 10 ** 9 and plan["fits"] is True
    big = tmem.plan_memory(ttr.TransformerConfig.llama_1b(), dp=1, tp=1,
                           batch_per_chip=64, seq=4096,
                           chip="NVIDIA H100 80GB HBM3")
    assert big["fits"] is False


def _keys():
    """The same call arguments in both frameworks."""
    out = []
    for n in (4, 4, 8, 4, 16, 32, 64, 64, 128):
        out.append(((jnp.zeros((2, n), jnp.float32),
                     {"b": jnp.zeros((n,), jnp.bfloat16), "a": 1}),
                    (torch.zeros(2, n),
                     {"b": torch.zeros(n, dtype=torch.bfloat16), "a": 1})))
    return out


def test_abstract_key_and_format_key_equal():
    for jargs, targs in _keys():
        assert tmem.abstract_key(targs) == jmem.abstract_key(jargs)
        assert tmem.format_key(tmem.abstract_key(targs)) == \
            jmem.format_key(jmem.abstract_key(jargs))
    # numpy leaves and long keys
    args = [np.zeros((3,), np.int32)] * 10
    assert tmem.abstract_key(args) == jmem.abstract_key(args)
    assert tmem.format_key(tmem.abstract_key(args)) == \
        jmem.format_key(jmem.abstract_key(args)) == \
        "int32[3] " * 7 + "int32[3] ...+2"


def _events(met, kind):
    return [e for e in met.get_registry().events() if e["event"] == kind]


def test_compile_tracker_equal_fed_the_same_keys(tmp_path):
    trackers = (tmem.CompileTracker(decay=0.5, threshold=0.4, min_misses=3),
                jmem.CompileTracker(decay=0.5, threshold=0.4, min_misses=3))
    outcomes = ([], [])
    for jargs, targs in _keys():
        outcomes[0].append(trackers[0].observe("site", targs))
        outcomes[1].append(trackers[1].observe("site", jargs))
        outcomes[0].append(trackers[0].observe("stable",
                                               (torch.zeros(8),)))
        outcomes[1].append(trackers[1].observe("stable",
                                               (jnp.zeros((8,)),)))
    assert outcomes[0] == outcomes[1]
    assert trackers[0].site_summary() == trackers[1].site_summary()
    assert trackers[0].site_summary()["site"]["storming"]
    for met in (tmetrics, jmetrics):
        snap = met.get_registry().snapshot()
        vals = snap["metrics"]["hvd_recompile_storms_total"]["values"]
        assert vals == [{"labels": {"site": "site"}, "value": 1.0}]
    assert [e["site"] for e in _events(tmetrics, "recompile_storm")] == \
        [e["site"] for e in _events(jmetrics, "recompile_storm")] == ["site"]
    assert len(_events(tmetrics, "compile_miss")) == \
        len(_events(jmetrics, "compile_miss"))
    assert not trackers[0].site_summary()["stable"]["storming"]
    dump = json.load(open(tmp_path / "flight-rank0.json"))
    assert dump["reason"] == "recompile_storm"


def test_ledger_snapshot_gauges_and_flight_section_equal():
    snaps, gauges, sections = [], [], []
    for mem, met, params in (
            (tmem, tmetrics, {"w": torch.zeros(16, 32),
                              "b": torch.zeros(32, dtype=torch.bfloat16)}),
            (jmem, jmetrics, {"w": jnp.zeros((16, 32), jnp.float32),
                              "b": jnp.zeros((32,), jnp.bfloat16)})):
        mem.reset(enabled=True)
        ledger = mem.get_ledger()
        ledger.account_tree("params", params)
        ledger.account("grads", 100)
        ledger.account("grads", 40)      # a re-statement
        ledger.set_activation_estimate(1000)
        snaps.append(ledger.snapshot())
        snap = met.get_registry().snapshot()["metrics"]
        gauges.append({k: snap[k]["values"] for k in
                       ("hvd_hbm_bytes", "hvd_hbm_capacity_bytes",
                        "hvd_hbm_headroom_bytes")})
        mem.get_tracker().observe("serve_decode", (params["w"],))
        sections.append(mem.flight_section())
    assert snaps[0] == snaps[1]
    assert snaps[0]["components"] == {"params": 16 * 32 * 4 + 32 * 2,
                                      "grads": 40, "activations": 1000}
    assert snaps[0]["measured_bytes_in_use"] is None
    assert gauges[0] == gauges[1]
    assert sections[0] == sections[1]


def test_plane_off_and_cpu_probes():
    tmem.reset(enabled=False)
    jmem.reset(enabled=False)
    assert tmem.flight_section() is None and jmem.flight_section() is None
    assert tmem.device_memory_stats(torch.device("cpu")) is None
    assert tmem.step_peak_bytes(torch.device("cpu")) is None
    assert tmem.live_array_bytes(torch.device("cpu")) is None
    tmem.reset_step_peak(torch.device("cpu"))   # a no-op on the CPU


def test_instrument_compiles_reports_each_call():
    calls = []
    f = tmem.instrument_compiles(lambda x: calls.append(x) or x, "site")
    for n in (2, 2, 3):
        f(torch.zeros(n))
    assert len(calls) == 3
    s = tmem.get_tracker().site_summary()["site"]
    assert (s["hits"], s["misses"]) == (1, 2)


def test_hvd_mem_selftest_and_plan_run(tmp_path):
    import os
    import subprocess
    import sys
    env = dict(os.environ, HVD_FLIGHT_DIR=str(tmp_path))
    cmd = [sys.executable, "-m", "horovod_tpu_torch.tools.hvd_mem"]
    proc = subprocess.run(cmd + ["--selftest"], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "hvd_mem --selftest: ok" in proc.stdout
    fits = subprocess.run(cmd + ["--plan", "--dp", "2", "--tp", "4",
                                 "--chip", "h100", "--batch-per-chip", "16",
                                 "--seq", "1024", "--json"],
                          capture_output=True, text=True, timeout=120)
    assert fits.returncode == 0, fits.stderr
    plan = json.loads(fits.stdout)
    assert plan["fits"] is True and plan["chip"] == "NVIDIA H100 80GB HBM3"
    over = subprocess.run(cmd + ["--plan", "--model", "llama_1b",
                                 "--batch-per-chip", "64", "--seq", "4096",
                                 "--chip", "h100"],
                          capture_output=True, text=True, timeout=120)
    assert over.returncode == 1 and "DOES NOT FIT" in over.stdout
