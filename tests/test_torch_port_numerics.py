"""The port's numerics plane (``horovod_tpu_torch/utils/numerics.py``)
against the JAX package's (``horovod_tpu/utils/numerics.py``), mirroring
``tests/test_numerics.py``:

  * ``tensor_stats`` / ``stats_vector`` / ``segment_stats``: fp32 norms
    and max-abs within rtol 1e-6 of the JAX functions on the same numpy
    inputs, nan/inf counts and zero fractions exact; bf16 inputs within
    rtol 1e-3. (The JAX cumsum-difference layout, for one huge slice
    beside many tiny ones, is only good to rtol 5e-3 itself; there the
    port is held to float64 numpy.)
  * the digest wire: ``make_record`` (the reference's seven fields, then
    the local checksum), ``fold_digest``, ``records_disagree`` and
    ``blame_rank`` equal on identical records and on a three-holder
    outlier; with two holders the reference's rule is symmetric and the
    port's checksum tie-break names the rank whose reduced copy strayed;
  * the monitor's anomaly policy (EMA, warmup, k, dedup) fed the same
    stats: the same gauges, counters and events;
  * the eager core on one CPU rank: a gradient with 3 NaNs raises
    ``hvd_nonfinite_total`` by 3 on each side, one ``numerics_anomaly``
    event, one flight dump, and the nonfinite alert rule fires;
  * two gloo ranks (the port's ``run()``, negotiated): rank 1 scales its
    reduced copy of one named tensor by 1 + 1e-2 and rank 0's
    coordinator names rank 1 in ``hvd_numerics_divergent_rank``.
"""

import glob
import math
import os

import numpy as np
import pytest
import torch

from horovod_tpu.utils import metrics as jm
from horovod_tpu.utils import numerics as jn
from horovod_tpu.utils import tracing as jt
from horovod_tpu_torch.run.launch import run
from horovod_tpu_torch.utils import metrics as tm
from horovod_tpu_torch.utils import numerics as tn
from horovod_tpu_torch.utils import tracing as tt

RUN_TIMEOUT_S = 120.0


def _np_stats(x):
    f = np.asarray(x, np.float64).reshape(-1)
    finite = np.isfinite(f)
    safe = np.where(finite, f, 0.0)
    n = f.size
    return [math.sqrt(float(np.sum(safe * safe))),
            float(np.max(np.abs(safe))) if n else 0.0,
            float(n - np.count_nonzero(finite)),
            float(np.count_nonzero(f == 0.0) / n) if n else 0.0,
            float(np.sum(safe))]


def _assert_rows(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    for g, w in zip(got.reshape(-1, 5), want.reshape(-1, 5)):
        np.testing.assert_allclose(g[[0, 1]], w[[0, 1]], rtol=rtol,
                                   atol=1e-30)
        assert g[2] == w[2]                 # nonfinite count: exact
        assert g[3] == pytest.approx(w[3], abs=1e-7)   # zero fraction
        np.testing.assert_allclose(g[4], w[4], rtol=max(rtol, 1e-5),
                                   atol=1e-5 * max(abs(w[0]), 1.0))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(777).astype(np.float32)
    x[3] = np.nan
    x[10] = np.inf
    x[11] = -np.inf
    x[20:30] = 0.0
    return x


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-6),
                                        ("bfloat16", 1e-3)])
def test_tensor_stats_equal(dtype, rtol):
    x = _inputs()
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    j = jn.stats_vector(np.asarray(t.float().numpy()).astype(
        np.float32) if dtype == "float32" else
        __import__("jax.numpy", fromlist=["x"]).asarray(
            x, dtype=__import__("jax.numpy", fromlist=["x"]).bfloat16))
    _assert_rows(tn.stats_vector(t).numpy(), np.asarray(j), rtol)
    s = tn.tensor_stats(t)
    assert float(s["nonfinite"]) == 3.0
    for empty in (torch.zeros(0), torch.zeros(0, 4)):
        assert all(float(v) == 0.0 for v in tn.tensor_stats(empty).values())
    ints = tn.tensor_stats(torch.tensor([[1, -2], [0, 4]], dtype=torch.int32))
    assert float(ints["nonfinite"]) == 0.0 and float(ints["max_abs"]) == 4.0


@pytest.mark.parametrize("sizes", [[16] * 8, [3, 17, 1, 30, 9], [5, 0, 3],
                                   [1]])
def test_segment_stats_equal(sizes):
    rng = np.random.default_rng(len(sizes))
    flat = rng.standard_normal(sum(sizes)).astype(np.float32)
    if flat.size:
        flat[0] = np.nan
        flat[-1] = 0.0
    got = tn.segment_stats(torch.from_numpy(flat), sizes).numpy()
    want = np.asarray(jn.segment_stats(flat, sizes))
    _assert_rows(got, want, 1e-6)
    assert np.all(np.isfinite(got))


def test_segment_stats_one_huge_slice_against_float64():
    sizes = [8192] + [2] * 40
    rng = np.random.default_rng(3)
    flat = rng.standard_normal(sum(sizes)).astype(np.float32)
    got = tn.segment_stats(torch.from_numpy(flat), sizes).numpy()
    off = 0
    want = []
    for s in sizes:
        want.append(_np_stats(flat[off:off + s]))
        off += s
    _assert_rows(got, np.array(want), 1e-6)


@pytest.mark.parametrize("sizes", [[255, 510, 1, 254], [0, 255, 0],
                                   [1000, 3, 0, 2000], [255 * 4]])
def test_segment_stats_row_edges_against_float64(sizes):
    # slices that start, end and fill the 255-element rows of the
    # additive statistics exactly, and one that ends the buffer on a row
    rng = np.random.default_rng(sum(sizes))
    flat = rng.standard_normal(sum(sizes)).astype(np.float32)
    for i, v in zip((1, 254, 255, 509), (np.nan, np.inf, 0.0, -np.inf)):
        if i < flat.size:
            flat[i] = v
    got = tn.segment_stats(torch.from_numpy(flat), sizes).numpy()
    off = 0
    want = []
    for s in sizes:
        want.append(_np_stats(flat[off:off + s]) if s else [0.0] * 5)
        off += s
    _assert_rows(got, np.array(want), 1e-6)


def test_segment_stats_bf16_equal():
    import jax.numpy as jnp
    sizes = [3, 17, 1, 30, 9]
    flat = np.random.default_rng(4).standard_normal(60).astype(np.float32)
    t = torch.from_numpy(flat).to(torch.bfloat16)
    want = np.asarray(jn.segment_stats(jnp.asarray(flat, jnp.bfloat16),
                                       sizes))
    _assert_rows(tn.segment_stats(t, sizes).numpy(), want, 1e-3)


def _rec(red_l2, loc_l2, red_sum=1.0, loc_sum=0.5, nf=0):
    row_red = [red_l2, 2.0, nf, 0.0, red_sum]
    row_loc = [loc_l2, 1.0, nf, 0.0, loc_sum]
    return tn.make_record(row_red, row_loc), jn.make_record(row_red, row_loc)


def test_digest_wire_equal():
    t, j = _rec(3.14159265, 2.71828182, red_sum=-1.234567891,
                loc_sum=0.5000001)
    assert t[:7] == j and len(t) == 8 and t[tn.R_LOC_SUM] == 0.5
    assert tn.DIGEST_VERSION == jn.DIGEST_VERSION
    assert (tn.R_RED_L2, tn.R_RED_MAX, tn.R_RED_NONFINITE, tn.R_RED_SUM,
            tn.R_LOC_L2, tn.R_LOC_MAX, tn.R_LOC_NONFINITE) == \
        (jn.R_RED_L2, jn.R_RED_MAX, jn.R_RED_NONFINITE, jn.R_RED_SUM,
         jn.R_LOC_L2, jn.R_LOC_MAX, jn.R_LOC_NONFINITE)
    assert tn.fold_digest(None, 3, {}) is None
    d_t = tn.fold_digest(tn.fold_digest(None, 3, {"g": t}, rank=1), 4,
                         {"h": t})
    d_j = jn.fold_digest(jn.fold_digest(None, 3, {"g": j}, rank=1), 4,
                         {"h": j})
    assert {c: {n: r[:7] for n, r in recs.items()}
            for c, recs in d_t["cycles"].items()} == d_j["cycles"]
    assert d_t["v"] == d_j["v"] and d_t["rank"] == d_j["rank"]
    for other in (_rec(3.14159265, 2.7), _rec(3.2, 2.7), _rec(3.14, 2.7,
                                                              nf=1)):
        assert tn.records_disagree(t, other[0]) == \
            jn.records_disagree(j, other[1])
        assert tn.records_disagree(t, other[0], tol=0.1) == \
            jn.records_disagree(j, other[1], tol=0.1)


def test_blame_equal_on_identical_records_and_outliers():
    same = _rec(3.0, 1.0)
    assert tn.blame_rank({r: same[0] for r in range(3)}) == \
        jn.blame_rank({r: same[1] for r in range(3)}) == 0
    assert tn.blame_rank({}) is None and jn.blame_rank({}) is None
    # three holders, one local-L2 outlier: the reference's rule
    recs = {0: _rec(3.0, 1.0), 1: _rec(3.0, 9.0), 2: _rec(3.0, 1.1)}
    assert tn.blame_rank({r: v[0] for r, v in recs.items()}) == \
        jn.blame_rank({r: v[1] for r, v in recs.items()}) == 1
    # a nonfinite local contribution is blamed outright
    recs = {0: _rec(3.0, 1.0), 1: _rec(3.0, 1.0, nf=2)}
    assert tn.blame_rank({r: v[0] for r, v in recs.items()}) == \
        jn.blame_rank({r: v[1] for r, v in recs.items()}) == 1


def test_two_holders_blame_the_stray_reduced_copy():
    """Rank 1's reduced copy strays by 1 %: the locals (checksums 0.4 and
    0.6, sum 1.0) say the reduced checksum is 1.0. The reference's rule
    is symmetric here and names rank 0; the port names rank 1 (ROADMAP
    §C)."""
    recs = {0: _rec(3.0, 1.0, red_sum=1.0, loc_sum=0.4),
            1: _rec(3.03, 2.0, red_sum=1.01, loc_sum=0.6)}
    assert jn.blame_rank({r: v[1] for r, v in recs.items()}) == 0
    assert tn.blame_rank({r: v[0] for r, v in recs.items()}) == 1
    # averaged allreduce: the reduced checksum is the locals' mean
    recs = {0: _rec(3.0, 1.0, red_sum=0.505, loc_sum=0.4),
            1: _rec(3.0, 2.0, red_sum=0.5, loc_sum=0.6)}
    assert tn.blame_rank({r: v[0] for r, v in recs.items()}) == 0


@pytest.fixture
def planes(tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_FLIGHT_DIR", str(tmp_path))
    regs = (tm.reset(enabled=True), jm.reset(enabled=True))
    tt.reset(enabled=True)
    jt.reset(enabled=True)
    mons = (tn.reset(enabled=True, ema_beta=0.5, ema_k=4.0, warmup=2),
            jn.reset(enabled=True, ema_beta=0.5, ema_k=4.0, warmup=2))
    yield regs, mons
    for mod in (tn, jn, tt, jt, tm, jm):
        mod.reset()


_FAMILIES = ("hvd_grad_norm", "hvd_grad_max_abs", "hvd_grad_zero_fraction",
             "hvd_grad_norm_ema", "hvd_grad_norm_drift",
             "hvd_nonfinite_total", "hvd_numerics_anomalies_total",
             "hvd_numerics_tensors_observed_total")


def _families(reg):
    snap = reg.snapshot()["metrics"]
    return {k: sorted((tuple(sorted(v["labels"].items())),
                       round(v["value"], 9))
                      for v in snap[k]["values"])
            for k in _FAMILIES if k in snap}


def _anomalies(reg):
    return [{k: e[k] for k in ("anomaly", "tensor", "cycle")}
            for e in reg.events() if e["event"] == "numerics_anomaly"]


def test_anomaly_policy_equal_fed_the_same_stats(planes):
    (treg, jreg), (tmon, jmon) = planes
    rng = np.random.default_rng(5)
    seq = []
    for step in range(12):
        w = rng.standard_normal(64).astype(np.float32)
        if step == 7:
            w = w * 100.0           # a spike after warmup
        z = np.zeros(8, np.float32)  # an all-zero warmup tensor
        if step == 9:
            z = np.ones(8, np.float32) * 50.0
        b = rng.standard_normal(16).astype(np.float32)
        if step in (4, 5):
            b[:3] = np.nan          # a nonfinite burst, flagged once
        seq.append([("w", w), ("z", z), ("b", b)])
    for step, items in enumerate(seq):
        cyc = step if step % 2 else None
        rt = tmon.observe([(n, torch.from_numpy(x), None)
                           for n, x in items], cycle=cyc)
        rj = jmon.observe([(n, x, None) for n, x in items], cycle=cyc)
        jmon.drain()
        assert sorted(rt) == sorted(rj)
        for n in rj:
            # fp32 sums in another order: the sixth digit may differ
            assert rt[n][:7] == pytest.approx(rj[n], rel=2e-6, abs=1e-9)
    ft, fj = _families(treg), _families(jreg)
    assert sorted(ft) == sorted(fj)
    for k in fj:
        assert [lab for lab, _ in ft[k]] == [lab for lab, _ in fj[k]]
        assert [v for _, v in ft[k]] == pytest.approx(
            [v for _, v in fj[k]], rel=1e-5, abs=1e-9)
    assert _anomalies(treg) == _anomalies(jreg)
    kinds = sorted(a["anomaly"] for a in _anomalies(treg))
    assert kinds == ["nonfinite", "norm_spike"]
    tmon.observe_compression("w", torch.ones(4), torch.zeros(4), "int8")
    jmon.observe_compression("w", np.ones(4, np.float32),
                             np.zeros(4, np.float32), "int8")
    for reg in (treg, jreg):
        vals = reg.snapshot()["metrics"]["hvd_compression_norm_delta"]
        assert vals["values"][0]["value"] == 1.0


def test_null_monitor_and_env_gate(monkeypatch):
    m = tn.reset(enabled=False)
    assert not m.enabled
    assert m.observe([("g", torch.ones(2), None)], cycle=1) == {}
    assert m.take_records() == {} and m.ingest_async([], None) == {}
    monkeypatch.setenv("HVD_NUMERICS", "0")
    assert not tn.reset().enabled
    monkeypatch.delenv("HVD_NUMERICS")
    assert tn.reset().enabled
    tn.reset()


def test_nan_gradient_through_the_eager_core(tmp_path, monkeypatch):
    """One CPU rank: a named gradient with exactly 3 NaNs through the
    eager core raises hvd_nonfinite_total by 3 on each side (one rank's
    reduced copy is its contribution, as in the reference), emits one
    numerics_anomaly event, writes one flight dump, and the nonfinite
    alert rule fires on its next tick; clean allreduces flag nothing."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils import alerts, history
    monkeypatch.setenv("HVD_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("HOROVOD_ALERT_FOR_S", "0")
    reg = tm.reset(enabled=True)
    tt.reset(enabled=True)
    tn.reset(enabled=True)
    mgr = alerts.reset(enabled=True, interval_s=0.0,
                       incident_dir=str(tmp_path / "incidents"),
                       history_writer=history.NullHistoryWriter())
    hvd.init(device="cpu")
    try:
        for _ in range(3):
            hvd.allreduce(torch.ones(64), name="clean", average=False)
        assert not _anomalies(reg)
        mgr.tick(0.0)
        g = torch.ones(64)
        g[[1, 5, 9]] = float("nan")
        hvd.allreduce(g, name="grad", average=False)
        snap = reg.snapshot()["metrics"]["hvd_nonfinite_total"]["values"]
        assert sorted((v["labels"]["where"], v["value"]) for v in snap
                      if v["labels"]["tensor"] == "grad") == \
            [("local", 3.0), ("reduced", 3.0)]
        evs = [e for e in reg.events() if e["event"] == "numerics_anomaly"]
        assert len(evs) == 1 and evs[0]["tensor"] == "grad"
        assert evs[0]["anomaly"] == "nonfinite"
        dumps = glob.glob(os.path.join(tmp_path, "flight-rank*.json"))
        assert len(dumps) == 1
        for now in (1.0, 2.0):
            mgr.tick(now)
        assert "nonfinite_burst" in mgr.firing()
    finally:
        hvd.shutdown()
        alerts.reset()
        tn.reset()
        tt.reset()
        tm.reset()


def _divergence_job():
    def fn():
        import time
        import torch
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.common import state
        from horovod_tpu_torch.utils import metrics
        hvd.init(device="cpu")
        coord = state.global_state().coordinator
        rank = hvd.rank()
        if rank == 1:
            coord.test_perturb = {"g.0": 1e-2}
        gen = torch.Generator().manual_seed(rank)
        for _ in range(3):
            hs = hvd.grouped_allreduce_async(
                [torch.randn(256, generator=gen),
                 torch.randn(64, generator=gen)], name="g", average=True)
            for h in hs:
                hvd.synchronize(h)
        out = {"rank": rank}
        if rank == 0:
            svc = coord._negotiator.service
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                flagged, first = svc.numerics_view()
                if any(k[2] == "divergence" for k in flagged):
                    break
                time.sleep(0.05)
            snap = metrics.get_registry().snapshot()["metrics"]
            out.update(
                flagged={f"{c}|{t}|{k}": b
                         for (c, t, k), b in flagged.items()},
                first_bad=first,
                divergent=snap["hvd_numerics_divergent_rank"]["values"][0]
                ["value"])
        else:
            time.sleep(1.0)   # keep cycling until rank 0 has its verdict
        hvd.shutdown()
        return out
    return fn


def test_two_ranks_the_coordinator_names_the_perturbed_rank(tmp_path):
    res = run(_divergence_job(), num_proc=2,
              env={"HVD_FLIGHT_DIR": str(tmp_path),
                   "HVD_FLIGHT_SIGTERM": "0"},
              start_timeout_s=RUN_TIMEOUT_S)
    r0 = res[0]
    div = {k: b for k, b in r0["flagged"].items()
           if k.endswith("|divergence")}
    assert div, r0
    assert {k.split("|")[1] for k in div} == {"g.0"}
    assert set(div.values()) == {1}
    assert r0["divergent"] == 1.0
    assert set(r0["first_bad"]) == {"g.0"}
