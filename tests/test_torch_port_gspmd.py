"""horovod_tpu_torch's GSPMD training step against the JAX package's.

The spec trees first, leaf by leaf: ``param_specs`` of the port (its
``[out, in]`` weights) against the JAX package's (its ``[in, out]``
kernels, so a 2-D kernel's spec reads reversed), tied and untied, and
``opt_state_specs`` of AdamW and SGD against optax's.

Then four gloo ranks, spawned once for the whole module, take the tiny
fp32 config from one flax checkpoint through ``make_gspmd_step`` (two
steps) and ``make_gspmd_multi_step`` (one call over the same two
batches) on dp2×tp2 and tp2×sp2 meshes, with SGD(0.1, momentum 0.9); the
tests hold each step's loss and the gathered parameters against the JAX
GSPMD step on a mesh of the same shape (4 of the 8 CPU devices, full
attention: the JAX step gathers the sequence, and every attention impl
computes the same function), fp32 within 1e-5 of each leaf's largest
magnitude. SGD, not AdamW: Adam's first update is about lr·sign(g), which
turns a 1e-9 difference in a near-zero gradient into an lr-sized one (the
port's AdamW is held to optax's in ``test_torch_port_train.py``). The
multi-step must land where two sequential steps land, a
``DistributedOptimizer`` (averaging over the mesh's dp axis) where the
plain optimizer does, and one tp step makes a fixed count of tp
collectives.
"""

import socket
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from horovod_tpu_torch import mpi_ops, optim, trainer
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import _dense_names, params_from_flax
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel.mesh import P

WORLD = 4
JOIN_TIMEOUT_S = 240
BATCH, SEQ, LR, MOMENTUM = 4, 32, 0.1, 0.9
# (name, mesh layout, port attention impl, tied embeddings)
LAYOUTS = (("dp2_tp2", dict(dp=2, tp=2), "flash", True),
           ("tp2_sp2", dict(tp=2, sp=2), "ring_flash", False),
           ("tp2_sp2_gather", dict(tp=2, sp=2), "flash", True))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tokens():
    return np.random.RandomState(7).randint(0, 256, (2, BATCH, SEQ)).astype(
        np.int32)


def _flax_path(name, num_layers=2):
    """A port parameter's flax path, and whether its 2-D weight is the
    flax kernel transposed."""
    for i in range(num_layers):
        dense = _dense_names(i)
        if name in dense:
            return dense[name], True
        for ln in ("ln_attn", "ln_mlp"):
            if name == f"layers.{i}.{ln}.scale":
                return (f"layer_{i}", ln, "scale"), False
    return {"embed.weight": (("embed", "embedding"), False),
            "ln_f.scale": (("ln_f", "scale"), False),
            "lm_head.weight": (("lm_head", "kernel"), True)}[name]


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _jax_params(tie):
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtr
    cfg = jtr.TransformerConfig.tiny(dtype=jnp.float32, tie_embeddings=tie)
    params = jtr.TransformerLM(cfg).init(
        jax.random.PRNGKey(3), jnp.zeros((2, SEQ), jnp.int32))["params"]
    return cfg, params


def _port_model(tree, impl, tie):
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32,
                                     attention_impl=impl,
                                     tie_embeddings=tie)
    return params_from_flax(tree, cfg, device="cpu", train=True)


# ---------------------------------------------------------------------------
# spec trees


@pytest.mark.parametrize("tie", [True, False])
def test_param_specs_match_jax_leaf_by_leaf(hvd, tie):
    import jax
    from horovod_tpu.models import transformer as jtr
    _, params = _jax_params(tie)
    jspecs = jtr.param_specs(params)
    model = _port_model(jax.device_get(params), "full", tie)
    got = ttr.param_specs(model)
    assert set(got) == {n for n, _ in model.named_parameters()}
    assert got == ttr.param_specs(dict(model.named_parameters()))
    for name, spec in got.items():
        path, transposed = _flax_path(name)
        want = tuple(_leaf(jspecs, path))
        if transposed:
            want = want[::-1]
        assert isinstance(spec, P)
        assert tuple(spec) == want, name


def test_batch_spec_matches_jax(hvd):
    from horovod_tpu.models import transformer as jtr
    for sp in (False, True):
        assert tuple(ttr.batch_spec(sp)) == tuple(jtr.batch_spec(sp))


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_opt_state_specs_match_optax(hvd, opt):
    import jax
    import optax
    from horovod_tpu import trainer as jtrainer
    from horovod_tpu.models import transformer as jtr
    _, params = _jax_params(True)
    jspecs = jtr.param_specs(params)
    tx = (optax.adamw(1e-3) if opt == "adamw"
          else optax.sgd(LR, momentum=MOMENTUM))
    jstate = jtrainer.opt_state_specs(tx, params, jspecs)
    model = _port_model(jax.device_get(params), "full", True)
    ttx = (optim.AdamW(model.parameters(), 1e-3) if opt == "adamw"
           else optim.SGD(model.parameters(), LR, momentum=MOMENTUM))
    got = trainer.opt_state_specs(ttx, model, ttr.param_specs(model))
    inner = jstate[0]
    keys = {"adamw": {"mu": "mu", "nu": "nu"}, "sgd": {"trace": "trace"}}[opt]
    for name, entry in got.items():
        path, transposed = _flax_path(name)
        for key, field in keys.items():
            want = tuple(_leaf(getattr(inner, field), path))
            assert tuple(entry[key]) == (want[::-1] if transposed else want)
        if opt == "adamw":
            assert tuple(entry["step"]) == tuple(inner.count) == ()


# ---------------------------------------------------------------------------
# the step on four gloo ranks


def _gathered(model):
    return {n: p.full_tensor().detach().numpy()
            for n, p in model.named_parameters()}


def _place(tree, impl, tie, mesh, dist_opt=False):
    model = _port_model(tree, impl, tie)
    specs = ttr.param_specs(model)
    trainer.place(model, mesh, specs)
    tx = optim.SGD(model.parameters(), LR, momentum=MOMENTUM)
    if dist_opt:
        tx = optim.DistributedOptimizer(tx)
    trainer.init_opt_state(tx, model)
    return model, tx, specs


def _run_layout(trees, layout, impl, tie):
    mesh = tmesh.build_mesh(**layout)
    sp = layout.get("sp", 1) > 1
    toks = torch.from_numpy(_tokens()).long()
    model, tx, specs = _place(trees[tie], impl, tie, mesh)
    step, pshard, bshard = trainer.make_gspmd_step(
        ttr.lm_loss_fn(model), tx, mesh, specs, ttr.batch_spec(sp))
    assert set(pshard) == set(specs) and tuple(bshard.spec) == tuple(
        ttr.batch_spec(sp))
    losses = [step(model, tx, toks[i])[2].item() for i in range(2)]
    out = {"losses": losses, "params": _gathered(model)}
    model, tx, specs = _place(trees[tie], impl, tie, mesh)
    multi, _, mshard = trainer.make_gspmd_multi_step(
        ttr.lm_loss_fn(model), tx, mesh, specs, ttr.batch_spec(sp))
    assert tuple(mshard.spec) == (None,) + tuple(ttr.batch_spec(sp))
    out["multi_loss"] = multi(model, tx, toks)[2].item()
    out["multi_params"] = _gathered(model)
    return out


def _dist_opt(trees):
    """dp2×tp2 with a DistributedOptimizer: it averages over dp itself."""
    mesh = tmesh.build_mesh(dp=2, tp=2)
    model, tx, specs = _place(trees[True], "flash", True, mesh, dist_opt=True)
    assert optim.averages_gradients(tx)
    assert dist.get_world_size(tx._process_group) == 2
    step, _, _ = trainer.make_gspmd_step(ttr.lm_loss_fn(model), tx, mesh,
                                         specs, ttr.batch_spec())
    toks = torch.from_numpy(_tokens()).long()
    losses = [step(model, tx, toks[i])[2].item() for i in range(2)]
    return {"losses": losses, "params": _gathered(model)}


_COUNTED = ("all_reduce", "all_gather_into_tensor", "all_gather_single",
            "reduce_scatter_tensor", "reduce_scatter_single",
            "batch_isend_irecv", "all_to_all_single")


def _count_tp_collectives(trees):
    """The collectives one step on a tp-only mesh (tp 4) makes: in the
    layers, the head and the loss (tp), and in the step's reductions."""
    mesh = tmesh.build_mesh(tp=4)
    model, tx, specs = _place(trees[True], "flash", True, mesh)
    step, _, _ = trainer.make_gspmd_step(ttr.lm_loss_fn(model), tx, mesh,
                                         specs, ttr.batch_spec())
    toks = torch.from_numpy(_tokens()[0]).long()
    step(model, tx, toks)   # the mesh's groups are built here
    counts = {}
    saved = {n: getattr(dist, n) for n in _COUNTED if hasattr(dist, n)}

    def counting(name, fn):
        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        return call
    for n, fn in saved.items():
        setattr(dist, n, counting(n, fn))
    try:
        step(model, tx, toks)
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)
    return counts


def _worker(r, port, trees, results):
    torch.set_num_threads(1)   # four ranks share the host's cores
    report = {}
    try:
        mpi_ops.init(device="cpu", rank=r, size=WORLD,
                     init_method=f"tcp://localhost:{port}")
        jobs = {name: (lambda layout=layout, impl=impl, tie=tie:
                       _run_layout(trees, layout, impl, tie))
                for name, layout, impl, tie in LAYOUTS}
        jobs["dist_opt"] = lambda: _dist_opt(trees)
        jobs["tp_collectives"] = lambda: _count_tp_collectives(trees)
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
    import jax
    trees = {tie: jax.device_get(_jax_params(tie)[1]) for tie in (True,
                                                                   False)}
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


def _jax_gspmd(layout, tie):
    """Two JAX GSPMD steps and one two-step multi-step call from the same
    checkpoint: (losses, params, multi loss, multi params)."""
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu import trainer as jtrainer
    from horovod_tpu.models import transformer as jtr
    from horovod_tpu.parallel import mesh as jmesh
    cfg, params0 = _jax_params(tie)
    model = jtr.TransformerLM(cfg)
    mesh = jmesh.build_mesh(devices=jax.devices()[:WORLD], **layout)
    specs = jtr.param_specs(params0)
    bspec = jtr.batch_spec(layout.get("sp", 1) > 1)
    tx = optax.sgd(LR, momentum=MOMENTUM)
    toks = jnp.asarray(_tokens())
    out = []
    for make in (jtrainer.make_gspmd_step, jtrainer.make_gspmd_multi_step):
        step, pshard, bshard = make(jtr.lm_loss_fn(model), tx, mesh, specs,
                                    bspec, params=params0, donate=False)
        params = jax.tree_util.tree_map(jax.device_put, params0, pshard)
        opt_state = jtrainer.init_opt_state(tx, params, mesh, specs)
        if make is jtrainer.make_gspmd_step:
            losses = []
            for i in range(2):
                params, opt_state, loss = step(
                    params, opt_state, jax.device_put(toks[i], bshard))
                losses.append(float(loss))
            out += [losses, jax.device_get(params)]
        else:
            params, opt_state, loss = step(params, opt_state,
                                           jax.device_put(toks, bshard))
            out += [float(loss), jax.device_get(params)]
    return out


def _assert_params(got, want_tree, label):
    for name, a in got.items():
        path, transposed = _flax_path(name)
        w = np.asarray(_leaf(want_tree, path))
        w = w.T if transposed else w
        np.testing.assert_allclose(a, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"{label} {name}")


@pytest.mark.parametrize("name,layout,impl,tie", LAYOUTS)
def test_steps_match_jax_gspmd(hvd, reports, name, layout, impl, tie):
    got = _report(reports, name)
    for r in range(1, WORLD):   # every rank reports the same loss
        assert reports[r][name]["losses"] == got["losses"]
    losses, params, multi_loss, multi_params = _jax_gspmd(layout, tie)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    _assert_params(got["params"], params, f"{name} step")
    np.testing.assert_allclose(got["multi_loss"], multi_loss, rtol=1e-5)
    _assert_params(got["multi_params"], multi_params, f"{name} multi")


@pytest.mark.parametrize("name", [n for n, _, _, _ in LAYOUTS])
def test_multi_step_equals_sequential_steps(reports, name):
    got = _report(reports, name)
    np.testing.assert_allclose(got["multi_loss"], got["losses"][-1],
                               rtol=1e-6)
    for n, a in got["params"].items():
        np.testing.assert_allclose(got["multi_params"][n], a, rtol=0,
                                   atol=1e-6 * np.abs(a).max(), err_msg=n)


def test_distributed_optimizer_averages_over_dp(reports):
    got, plain = _report(reports, "dist_opt"), _report(reports, "dp2_tp2")
    np.testing.assert_allclose(got["losses"], plain["losses"], rtol=1e-6)
    for n, a in plain["params"].items():
        np.testing.assert_allclose(got["params"][n], a, rtol=0,
                                   atol=1e-6 * np.abs(a).max(), err_msg=n)


def test_tp_step_collective_count(reports):
    """One tp step of the tied tiny model (2 layers) on tp 4: per layer the
    qkv weight's all-gather, the attention's and the MLP's row-parallel
    all-reduces (forward), the two column-parallel inputs' gradient
    all-reduces and the qkv weight gradient's reduce-scatter (backward);
    the vocab-parallel lookup's all-reduce, the head input's gradient
    all-reduce and the loss's max, sum-of-exponentials and target
    all-reduces: 6·2 + 5 = 17, and nothing else (no dp or sp axis to
    reduce over, no DTensor redistribution)."""
    counts = _report(reports, "tp_collectives")
    gathers = sum(counts.get(n, 0) for n in ("all_gather_into_tensor",
                                             "all_gather_single"))
    scatters = sum(counts.get(n, 0) for n in ("reduce_scatter_tensor",
                                              "reduce_scatter_single"))
    assert gathers == 2 and scatters == 2
    assert counts.get("all_reduce", 0) == 13
    assert sum(counts.values()) == 17
