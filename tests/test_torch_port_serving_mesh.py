"""horovod_tpu_torch's serving on the tensor-parallel mesh against the JAX
package's, and the tp path where tp does not divide the heads.

Four gloo ranks, spawned once for the module, serve the JAX engine's tiny
fp32 checkpoint through ``ServeEngine(mesh=...)``:
  * on dp2×tp2 (each dp way a tp-2 engine), against the JAX
    ``ServeEngine(mesh=build_mesh(tp=2))`` on the virtual CPU devices: the
    temperature-0 tokens equal, ``per_chip_bytes`` equal, ``load_snapshot``
    equal after the same submissions and two steps, the collectives of one
    decode step counted (2·layers activation all-reduces, one logits
    gather, no weight collective) and ``resharding_report`` empty;
  * at tp 4 with 6 heads (d_model 96), which tp does not divide: every
    rank computes every head, the KV cache is replicated; tokens equal
    the JAX engine's on build_mesh(tp=4);
  * one GSPMD training step of the same 6-head model at tp 4 (SGD with
    momentum), against the JAX GSPMD step, fp32 within 1e-5 of each
    leaf's largest magnitude (the tolerance of test_torch_port_gspmd.py);
  * a drill of the sentinel: layer 0's row-sharded ``out`` weight gathered
    whole at each use; ``resharding_report`` names that leaf and 'tp'.
    The reference's own drill is not taken as ground truth: its
    ``TestReshardingSentinel::test_mis_specced_jit_names_leaf_and_axis``
    fails on the JAX side.
Without ranks: ``kv_cache_spec`` and ``decode_head_sharding`` against the
JAX functions for heads/tp 6/2, 6/3, 6/4, 4/4 and one card.
"""

import dataclasses
import socket
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

from horovod_tpu_torch import mpi_ops, optim, trainer
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.serving.engine import ServeEngine
from horovod_tpu_torch.serving.queue import AdmissionQueue, Request

WORLD = 4
JOIN_TIMEOUT_S = 240
PROMPTS = [(5, 9, 17), (4, 8, 15, 16, 23, 42)]
N_NEW = 8
SLOTS, MAX_LEN, KV_BLOCK = 2, 48, 8
BATCH, SEQ, LR, MOMENTUM = 4, 32, 0.1, 0.9
WIDE = dict(num_heads=6, d_model=96)   # 6 heads: tp 4 does not divide them


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_cfg(six_heads, tie=False):
    from horovod_tpu.models import transformer as jtr
    cfg = jtr.TransformerConfig.tiny(dtype=jnp.float32,
                                     attention_impl="full",
                                     tie_embeddings=tie)
    return dataclasses.replace(cfg, **WIDE) if six_heads else cfg


def _jax_params(six_heads, tie=False):
    from horovod_tpu.models import transformer as jtr
    cfg = _jax_cfg(six_heads, tie)
    return jtr.TransformerLM(cfg).init(
        jax.random.PRNGKey(3), jnp.zeros((2, SEQ), jnp.int32))["params"]


def _port_cfg(six_heads, impl="flash", tie=False):
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32,
                                     attention_impl=impl,
                                     tie_embeddings=tie)
    return dataclasses.replace(cfg, **WIDE) if six_heads else cfg


def _queue():
    return AdmissionQueue(max_depth=64, admission_timeout_s=1e9)


# ---------------------------------------------------------------------------
# the rank side


def _serve(tree, six_heads, layout, drill=False):
    mesh = tmesh.build_mesh(**layout)
    cfg = _port_cfg(six_heads)
    model = params_from_flax(tree, cfg, device="cpu")
    engine = ServeEngine(cfg, model, num_slots=SLOTS, max_len=MAX_LEN,
                         kv_block=KV_BLOCK, queue=_queue(), device="cpu",
                         mesh=mesh)
    if drill:
        _drill(engine)
        return {"report": engine.resharding_report()}
    for i, p in enumerate(PROMPTS):
        engine.submit(Request(f"r{i}", p, max_new_tokens=N_NEW))
    out = []
    for _ in range(2):
        out.extend(engine.step())
    snap = engine.load_snapshot()
    out.extend(engine.run_to_completion())
    engine.params.counts.clear()
    report = engine.resharding_report()
    return {"tokens": {r.request_id: list(r.tokens) for r in out},
            "snapshot": snap, "kv_bytes": engine.kv.per_chip_bytes(),
            "kv_shape": tuple(engine.kv.k.shape),
            "step_counts": dict(engine.params.counts), "report": report,
            "generation": engine.generation}


def _drill(engine):
    """Layer 0's row-parallel ``out`` weight consumed whole: its shard is
    all-gathered to the full ``[d_model, d_model]`` at every use (the
    columns this rank needs are then sliced back, so the result is
    unchanged)."""
    w = engine.params
    first = w.layers[0]
    attn_out = w.attn_out

    def gathered(layer, attn):
        if layer is not first:
            return attn_out(layer, attn)
        full = w.all_gather(layer.out, 1, "weight_gather")
        n = layer.out.shape[1]
        cols = full[:, w.tp_rank * n:(w.tp_rank + 1) * n]
        return w.all_reduce(w.dense(attn, cols))
    w.attn_out = gathered


def _gathered(model):
    return {n: p.full_tensor().detach().numpy()
            for n, p in model.named_parameters()}


def _train(tree):
    """One GSPMD step of the 6-head model at tp 4."""
    mesh = tmesh.build_mesh(tp=4)
    cfg = _port_cfg(True, impl="flash", tie=True)
    model = params_from_flax(tree, cfg, device="cpu", train=True)
    specs = ttr.param_specs(model)
    trainer.place(model, mesh, specs)
    tx = optim.SGD(model.parameters(), LR, momentum=MOMENTUM)
    trainer.init_opt_state(tx, model)
    step, _, _ = trainer.make_gspmd_step(ttr.lm_loss_fn(model), tx, mesh,
                                         specs, ttr.batch_spec())
    toks = torch.from_numpy(_tokens()).long()
    loss = step(model, tx, toks)[2].item()
    return {"loss": loss, "params": _gathered(model)}


def _tokens():
    return np.random.RandomState(7).randint(0, 256, (BATCH, SEQ)).astype(
        np.int32)


def _worker(r, port, trees, results):
    torch.set_num_threads(1)   # four ranks share the host's cores
    report = {}
    try:
        mpi_ops.init(device="cpu", rank=r, size=WORLD,
                     init_method=f"tcp://localhost:{port}")
        jobs = {"tp2": lambda: _serve(trees["tiny"], False,
                                      dict(dp=2, tp=2)),
                "tp4_six_heads": lambda: _serve(trees["six"], True,
                                                dict(tp=4)),
                "drill": lambda: _serve(trees["tiny"], False,
                                        dict(dp=2, tp=2), drill=True),
                "train_tp4": lambda: _train(trees["six_tied"])}
        for name, job in jobs.items():
            try:
                report[name] = job()
            except Exception:  # noqa: BLE001 — reported to the parent
                report[name] = traceback.format_exc()
        mpi_ops.shutdown()
    except Exception:  # noqa: BLE001
        report["init"] = traceback.format_exc()
    results.put((r, report))


@pytest.fixture(scope="module")
def reports():
    trees = {"tiny": jax.device_get(_jax_params(False)),
             "six": jax.device_get(_jax_params(True)),
             "six_tied": jax.device_get(_jax_params(True, tie=True))}
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, trees, results))
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
    return reports[0][name]


# ---------------------------------------------------------------------------
# the JAX side


def _jax_engine(six_heads, tp):
    """The JAX tp engine over ``build_mesh(tp=tp)`` on the virtual CPU
    devices: (tokens, snapshot after two steps, per-chip KV bytes as
    placed, before XLA's steps return the cache in layouts of their
    own)."""
    from horovod_tpu.parallel import mesh as jmesh
    from horovod_tpu.serving import queue as jqueue
    from horovod_tpu.serving.engine import ServeEngine as JaxEngine
    mesh = jmesh.build_mesh(tp=tp)
    jmesh.set_global_mesh(mesh)
    try:
        engine = JaxEngine(_jax_cfg(six_heads), _jax_params(six_heads),
                           num_slots=SLOTS, max_len=MAX_LEN,
                           kv_block=KV_BLOCK, mesh=mesh,
                           queue=jqueue.AdmissionQueue(
                               max_depth=64, admission_timeout_s=1e9))
        kv_bytes = engine.kv.per_chip_bytes()
        for i, p in enumerate(PROMPTS):
            engine.submit(jqueue.Request(f"r{i}", p, max_new_tokens=N_NEW))
        out = []
        for _ in range(2):
            out.extend(engine.step())
        snap = engine.load_snapshot()
        out.extend(engine.run_to_completion())
        return ({r.request_id: list(r.tokens) for r in out}, snap,
                kv_bytes)
    finally:
        jmesh.reset_global_mesh()


def test_tp2_tokens_bytes_and_snapshot_equal_jax(hvd, reports):
    got = _report(reports, "tp2")
    for r in range(1, WORLD):   # every rank serves the same tokens
        assert reports[r]["tp2"]["tokens"] == got["tokens"]
    tokens, snap, kv_bytes = _jax_engine(False, 2)
    assert got["tokens"] == tokens
    assert all(len(t) == N_NEW for t in tokens.values())
    assert got["kv_bytes"] == kv_bytes
    assert got["snapshot"] == snap
    assert got["generation"] == 0
    # [layers, slots, len, heads / tp, head_dim]
    assert got["kv_shape"] == (2, SLOTS, MAX_LEN, 2, 16)


def test_tp2_decode_step_collectives_and_clean_report(reports):
    """One decode step: 2 · layers activation all-reduces (after out and
    after down), one gather of the head's logits, nothing on a weight,
    and the sentinel finds nothing."""
    got = _report(reports, "tp2")
    assert got["step_counts"] == {"activation_all_reduce": 4,
                                  "logits_gather": 1}
    assert got["report"] == []


def test_tp4_six_heads_tokens_equal_jax(hvd, reports):
    got = _report(reports, "tp4_six_heads")
    tokens, _, kv_bytes = _jax_engine(True, 4)
    assert got["tokens"] == tokens
    # the cache is replicated: every head on every rank
    assert got["kv_shape"] == (2, SLOTS, MAX_LEN, 6, 16)
    assert got["kv_bytes"] == kv_bytes
    assert got["report"] == []


def test_drill_names_the_leaf_and_the_axis(reports):
    findings = _report(reports, "drill")["report"]
    assert [f["leaf"] for f in findings] == ["layers.0.attn.out.weight"]
    assert findings[0]["axis"] == "tp" and findings[0]["dim"] == 1
    assert findings[0]["full_shape"] == [64, 64]
    assert findings[0]["shard_shape"] == [64, 32]


def _flax_path(name):
    from horovod_tpu_torch.models.convert import _dense_names
    for i in range(2):
        dense = _dense_names(i)
        if name in dense:
            return dense[name], True
        for ln in ("ln_attn", "ln_mlp"):
            if name == f"layers.{i}.{ln}.scale":
                return (f"layer_{i}", ln, "scale"), False
    return {"embed.weight": (("embed", "embedding"), False),
            "ln_f.scale": (("ln_f", "scale"), False)}[name]


def test_tp4_six_heads_training_step_equals_jax(hvd, reports):
    import optax
    from horovod_tpu import trainer as jtrainer
    from horovod_tpu.models import transformer as jtr
    from horovod_tpu.parallel import mesh as jmesh
    got = _report(reports, "train_tp4")
    for r in range(1, WORLD):
        assert reports[r]["train_tp4"]["loss"] == got["loss"]
    cfg = _jax_cfg(True, tie=True)
    params0 = _jax_params(True, tie=True)
    mesh = jmesh.build_mesh(devices=jax.devices()[:WORLD], tp=4)
    specs = jtr.param_specs(params0)
    tx = optax.sgd(LR, momentum=MOMENTUM)
    step, pshard, bshard = jtrainer.make_gspmd_step(
        jtr.lm_loss_fn(jtr.TransformerLM(cfg)), tx, mesh, specs,
        jtr.batch_spec(), params=params0, donate=False)
    params = jax.tree_util.tree_map(jax.device_put, params0, pshard)
    opt_state = jtrainer.init_opt_state(tx, params, mesh, specs)
    params, _, loss = step(params, opt_state,
                           jax.device_put(jnp.asarray(_tokens()), bshard))
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    want = jax.device_get(params)
    for name, a in got["params"].items():
        path, transposed = _flax_path(name)
        w = want
        for key in path:
            w = w[key]
        w = np.asarray(w)
        w = w.T if transposed else w
        np.testing.assert_allclose(a, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)



# ---------------------------------------------------------------------------
# the serving specs, no ranks needed


@pytest.mark.parametrize("heads,tp", [(6, 2), (6, 3), (6, 4), (4, 4),
                                      (6, 1)])
def test_kv_cache_spec_and_decode_head_sharding_match_jax(hvd, heads, tp):
    from horovod_tpu.parallel import mesh as jmesh
    jm = jmesh.build_mesh(devices=jax.devices()[:tp], tp=tp)
    tm = tmesh.build_mesh(tp=tp, devices=list(range(tp)))
    assert tuple(tmesh.kv_cache_spec(heads, tm)) == \
        tuple(jmesh.kv_cache_spec(heads, jm))
    assert tmesh.decode_head_sharding(heads) is None
    assert jmesh.decode_head_sharding(heads) is None
    jmesh.set_global_mesh(jm)
    tmesh.set_global_mesh(tm)
    try:
        want = jmesh.decode_head_sharding(heads)
        got = tmesh.decode_head_sharding(heads)
        assert (got is None) == (want is None)
        if want is not None:
            assert tuple(got.spec) == tuple(want.spec)
            assert got.local_heads() == heads // tp
    finally:
        jmesh.reset_global_mesh()
        tmesh.reset_global_mesh()


def test_decode_attention_refuses_heads_that_are_not_its_shard():
    from horovod_tpu_torch.ops.flash_attention import decode_attention
    tm = tmesh.build_mesh(tp=2, devices=[0, 1])
    heads = tmesh.decode_head_sharding(4, tm)
    q = torch.zeros(1, 1, 4, 8)
    kv = torch.zeros(1, 16, 4, 8)
    with pytest.raises(ValueError, match="head sharding"):
        decode_attention(q, kv, kv, torch.tensor([3]), head_sharding=heads)
    out = decode_attention(q[:, :, :2], kv[:, :, :2], kv[:, :, :2],
                           torch.tensor([3]), head_sharding=heads)
    assert out.shape == (1, 1, 2, 8)
