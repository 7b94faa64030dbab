"""horovod_tpu_torch's expert-parallel GSPMD step against the JAX
package's.

Four gloo ranks, spawned once for the whole module, take the tiny fp32
config with 4 experts, from one flax init, through ``make_gspmd_step``
(SGD with momentum, two steps) on dp2×ep2, ep2×tp2 and sp2×ep2 (the
port's ring_flash; the JAX side full attention, which its GSPMD gathers
the sequence for): each step's loss and the gathered parameters against
the JAX GSPMD step on a mesh of the same shape (4 of the 8 CPU devices)
within 1e-5 of each leaf's largest magnitude; the replicated leaves
bit-equal on the ep ranks after the steps (no reduction over 'ep'); one
ep-4 forward against the unsharded model (as
``test_ep_sharded_matches_unsharded``), with one ep all-reduce per MoE
layer and no other collective.
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
from horovod_tpu_torch.models.convert import flax_mapping, params_from_flax
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import tensor_parallel as tpl

from test_torch_port_moe import (EXPERTS, SEQ, _hold, _jax_model_params,
                                 _leaf, _model_cfgs)

WORLD = 4
JOIN_TIMEOUT_S = 240
BATCH, LR, MOMENTUM = 4, 0.1, 0.9
# (name, mesh layout, port attention impl, tied embeddings)
LAYOUTS = (("dp2_ep2", dict(dp=2, ep=2), "flash", False),
           ("ep2_tp2", dict(ep=2, tp=2), "flash", True),
           ("sp2_ep2", dict(sp=2, ep=2), "ring_flash", False))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the GSPMD step on four gloo ranks


def _tokens():
    return np.random.RandomState(7).randint(0, 256, (2, BATCH, SEQ)).astype(
        np.int32)


def _gathered(model):
    return {n: p.full_tensor().detach().numpy()
            for n, p in model.named_parameters()}


def _run_layout(trees, layout, impl, tie):
    mesh = tmesh.build_mesh(**layout)
    sp = layout.get("sp", 1) > 1
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32, attention_impl=impl,
                                     num_experts=EXPERTS, tie_embeddings=tie)
    model = params_from_flax(trees[tie], cfg, device="cpu", train=True)
    specs = ttr.param_specs(model)
    trainer.place(model, mesh, specs)
    tx = optim.SGD(model.parameters(), LR, momentum=MOMENTUM)
    trainer.init_opt_state(tx, model)
    step, _, _ = trainer.make_gspmd_step(ttr.lm_loss_fn(model), tx, mesh,
                                         specs, ttr.batch_spec(sp))
    toks = torch.from_numpy(_tokens()).long()
    losses = [step(model, tx, toks[i])[2].item() for i in range(2)]
    # this rank's copy of every leaf no axis shards: equal on the ep ranks
    replicated = {n: tpl.local(p).detach().numpy().copy()
                  for n, p in model.named_parameters()
                  if all(not pl.is_shard() for pl in p.placements)}
    return {"losses": losses, "params": _gathered(model),
            "replicated": replicated,
            "ep_rank": mesh.coordinate("ep")}


_COUNTED = ("all_reduce", "all_gather_into_tensor", "all_gather_single",
            "reduce_scatter_tensor", "reduce_scatter_single",
            "batch_isend_irecv", "all_to_all_single")


def _ep4_forward(trees):
    """The model on an ep-4 mesh against the unsharded model, and the
    collectives of one forward."""
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32,
                                     num_experts=EXPERTS)
    toks = torch.from_numpy(_tokens()[0]).long()
    ref = params_from_flax(trees[False], cfg, device="cpu")
    with torch.no_grad():
        want = ref(toks)
    mesh = tmesh.build_mesh(ep=WORLD)
    model = params_from_flax(trees[False], cfg, device="cpu")
    trainer.place(model, mesh, ttr.param_specs(model))
    with torch.no_grad():
        model(toks)     # the mesh's groups are built here
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
        with torch.no_grad():
            got = model(toks)
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)
    return {"got": got.numpy(), "want": want.numpy(), "counts": counts,
            "layers": cfg.num_layers}


def _worker(r, port, trees, results):
    torch.set_num_threads(1)   # four ranks share the host's cores
    report = {}
    try:
        mpi_ops.init(device="cpu", rank=r, size=WORLD,
                     init_method=f"tcp://localhost:{port}")
        jobs = {name: (lambda layout=layout, impl=impl, tie=tie:
                       _run_layout(trees, layout, impl, tie))
                for name, layout, impl, tie in LAYOUTS}
        jobs["ep4_forward"] = lambda: _ep4_forward(trees)
        for name, job in jobs.items():
            try:
                report[name] = job()
            except Exception:  # noqa: BLE001 — reported to the parent
                report[name] = traceback.format_exc()
        mpi_ops.shutdown()
    except Exception:  # noqa: BLE001
        report["init"] = traceback.format_exc()
    results.put((r, report))


# the JAX GSPMD step's (losses, params) by layout name, computed by the
# ``reports`` fixture while the ranks run
_JAX = {}


def _jax_gspmd(layout, tie):
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu import trainer as jtrainer
    from horovod_tpu.models import transformer as jtr
    from horovod_tpu.parallel import mesh as jmesh
    jcfg, _ = _model_cfgs(tie)
    params0 = _jax_model_params(tie)
    model = jtr.TransformerLM(jcfg)
    mesh = jmesh.build_mesh(devices=jax.devices()[:WORLD], **layout)
    specs = jtr.param_specs(params0)
    tx = optax.sgd(LR, momentum=MOMENTUM)
    step, pshard, bshard = jtrainer.make_gspmd_step(
        jtr.lm_loss_fn(model), tx, mesh, specs,
        jtr.batch_spec(layout.get("sp", 1) > 1), params=params0,
        donate=False)
    params = jax.tree_util.tree_map(jax.device_put, params0, pshard)
    opt_state = jtrainer.init_opt_state(tx, params, mesh, specs)
    toks = jnp.asarray(_tokens())
    losses = []
    for i in range(2):
        params, opt_state, loss = step(params, opt_state,
                                       jax.device_put(toks[i], bshard))
        losses.append(float(loss))
    return losses, jax.device_get(params)


@pytest.fixture(scope="module")
def reports():
    trees = {tie: _jax_model_params(tie) for tie in (False, True)}
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, trees, results))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        for name, layout, _, tie in LAYOUTS:
            _JAX[name] = _jax_gspmd(layout, tie)
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


@pytest.mark.parametrize("name,layout,impl,tie", LAYOUTS)
def test_steps_match_jax_gspmd(hvd, reports, name, layout, impl, tie):
    got = _report(reports, name)
    for r in range(1, WORLD):   # every rank reports the same loss
        assert got[r]["losses"] == got[0]["losses"]
    losses, params = _JAX[name]
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-5)
    _, tcfg = _model_cfgs(tie)
    for n, a in got[0]["params"].items():
        path, transposed = flax_mapping(tcfg)[n]
        w = np.asarray(_leaf(params, path))
        _hold(a, w.T if transposed else w, f"{name} {n}")


@pytest.mark.parametrize("name", [n for n, _, _, _ in LAYOUTS])
def test_replicated_leaves_equal_on_the_ep_ranks(reports, name):
    """No reduction over 'ep': the ep ranks' copies of every replicated
    leaf come out of the steps bit-equal (the expert branch's input
    gradient and the gates' gradient are summed over 'ep' in the layer)."""
    got = _report(reports, name)
    by_ep = {}
    for rep in got:
        by_ep.setdefault(rep["ep_rank"], []).append(rep["replicated"])
    assert sorted(by_ep) == [0, 1]
    for a, b in zip(by_ep[0], by_ep[1]):
        assert set(a) == set(b) and a
        for n in a:
            np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def test_ep4_forward_matches_unsharded(reports):
    got = _report(reports, "ep4_forward")
    for rep in got:
        np.testing.assert_allclose(rep["got"], rep["want"], rtol=2e-5,
                                   atol=2e-5)
        # one ep all-reduce per MoE layer (the combine's partial sums)
        assert rep["counts"] == {"all_reduce": rep["layers"]}, rep["counts"]
