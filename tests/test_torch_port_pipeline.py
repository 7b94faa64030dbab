"""horovod_tpu_torch's GPipe pipeline against the JAX package's.

Four gloo ranks, spawned once for the whole module, run:

  * ``gpipe`` over a pp-4 ring, each stage ``tanh(a @ W[stage])``, forward
    and gradient (of ``W`` and of the microbatches) against the serial
    run of the four stages (``TestGpipePrimitive`` of the JAX tests) and
    against the JAX ``gpipe`` under ``shard_map`` on a pp-4 mesh; every
    bubble tick's output cotangent is exactly zero;
  * ``make_pipeline_step`` on dp2×pp2, pp2×tp2 and pp2×sp2 (the port's
    ring_flash and ring; the JAX side ring), the tiny fp32 untied config
    from one flax init, SGD, two steps: each step's loss and the gathered
    parameters against the JAX ``make_pipeline_step`` on a mesh of the
    same shape (4 of the 8 CPU devices) and against the port's
    unpipelined GSPMD step, within 1e-5 of each leaf's largest magnitude;
  * the two refusals that need a batch (a local batch the microbatches do
    not divide, a sequence sp does not divide).

In this process: ``stack``/``unstack`` against the JAX functions,
``pipeline_param_specs`` against the JAX spec trees, and the three
refusals made when the step is built.
"""

import socket
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from horovod_tpu_torch import mpi_ops, optim, trainer
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import flax_mapping, params_from_flax
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import pipeline as tpl_pipe
from horovod_tpu_torch.parallel.mesh import P

WORLD = 4
JOIN_TIMEOUT_S = 240
LR, MICRO, STEPS = 0.05, 2, 2
# (name, mesh layout, port attention impl, JAX attention impl)
LAYOUTS = (("dp2_pp2", dict(dp=2, pp=2), "flash", "full"),
           ("pp2_tp2", dict(pp=2, tp=2), "flash", "full"),
           ("pp2_sp2_ring_flash", dict(pp=2, sp=2), "ring_flash", "ring"),
           ("pp2_sp2_ring", dict(pp=2, sp=2), "ring", "ring"))
# gpipe: 4 stages of [3, 3], 6 microbatches of [2, 3]
G_STAGES, G_MICRO = 4, 6


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tokens():
    return np.random.RandomState(0).randint(0, 256, (STEPS, 8, 33)).astype(
        np.int32)


def _gpipe_inputs():
    rng = np.random.RandomState(0)
    return (rng.randn(G_STAGES, 3, 3).astype(np.float32),
            rng.randn(G_MICRO, 2, 3).astype(np.float32))


def _jax_cfg(impl="full"):
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtr
    return jtr.TransformerConfig.tiny(dtype=jnp.float32, attention_impl=impl)


def _jax_params():
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtr
    return jax.device_get(jtr.TransformerLM(_jax_cfg()).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32), jnp.int32))["params"])


def _port_cfg(impl="flash"):
    return ttr.TransformerConfig.tiny(dtype=torch.float32,
                                      attention_impl=impl)


def _stacked_path(name, cfg):
    """The JAX pipeline tree's path of a port pipeline leaf, and whether
    the leaf is that kernel transposed."""
    mapping = flax_mapping(cfg)
    if isinstance(name, tuple):          # ("layers", suffix)
        path, transposed = mapping[f"layers.0.{name[1]}"]
        return ("layers",) + path[1:], transposed
    return mapping[name]


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


# ---------------------------------------------------------------------------
# the worker jobs


def _gpipe_job():
    """gpipe over the world's pp ring: the last stage's outputs on every
    rank, this stage's W gradient, stage 0's microbatch gradient, and
    whether every bubble tick's output cotangent was exactly zero."""
    w_all, x = _gpipe_inputs()
    mesh = tmesh.build_mesh(pp=G_STAGES)
    ring = mesh.comm("pp")
    w = torch.from_numpy(w_all[ring.rank].copy()).requires_grad_(True)
    xs = torch.from_numpy(x).requires_grad_(True)
    ticks, cotangents = [0], {}

    def stage_fn(a):
        t = ticks[0]
        ticks[0] += 1
        y = torch.tanh(a @ w)
        y.register_hook(lambda g, t=t: cotangents.__setitem__(t, g.clone()))
        return y
    out = tpl_pipe.last_stage_value(tpl_pipe.gpipe(stage_fn, xs, ring), ring)
    (out ** 2).sum().backward()
    bubble_zero = all(
        int(torch.count_nonzero(g)) == 0 for t, g in cotangents.items()
        if not 0 <= t - ring.rank < G_MICRO)
    return {"out": out.detach().numpy(), "dw": w.grad.numpy(),
            "dx": xs.grad.numpy(), "ticks": ticks[0],
            "bubble_zero": bubble_zero,
            "bubble_ticks": sum(1 for t in cotangents
                                if not 0 <= t - ring.rank < G_MICRO)}


def _place(tree, layout, impl):
    cfg = _port_cfg(impl)
    mesh = tmesh.build_mesh(**layout)
    model = params_from_flax(tree, cfg, device="cpu", train=True)
    whole = tpl_pipe.stack_pipeline_params(model, cfg.num_layers)
    specs = tpl_pipe.pipeline_param_specs(
        whole, tp=tmesh.mesh_axis_size(mesh, "tp") > 1)
    placed = tpl_pipe.place_pipeline_params(
        whole, tmesh.tree_shardings(specs, mesh))
    tx = optim.SGD(tpl_pipe.pipeline_leaves(placed), LR)
    return cfg, mesh, placed, tx


def _gathered(placed):
    out = {("layers", n): p.full_tensor().detach().numpy()
           for n, p in placed["layers"].items()}
    out.update({n: p.full_tensor().detach().numpy()
                for n, p in placed.items() if n != "layers"})
    return out


def _pipeline_job(tree, layout, impl):
    cfg, mesh, placed, tx = _place(tree, layout, impl)
    step, pshard, bshard = tpl_pipe.make_pipeline_step(cfg, tx, mesh, MICRO,
                                                       placed)
    toks = torch.from_numpy(_tokens()).long()
    losses = []
    for i in range(STEPS):
        placed, tx, loss = step(placed, tx, toks[i])
        losses.append(loss.item())
    return {"losses": losses, "params": _gathered(placed),
            "batch_spec": tuple(bshard.spec),
            "qkv_spec": tuple(pshard["layers"]["attn.qkv.weight"].spec)}


def _gspmd_job(tree):
    """The port's unpipelined GSPMD step on dp 4, the pipeline's loss (the
    shifted split), the same SGD: losses and parameters stacked."""
    cfg = _port_cfg()
    mesh = tmesh.build_mesh(dp=WORLD)
    model = params_from_flax(tree, cfg, device="cpu", train=True)
    specs = ttr.param_specs(model)
    trainer.place(model, mesh, specs)
    tx = optim.SGD(model.parameters(), LR)

    def loss_fn(model, tokens):
        tokens = tokens.to_local()
        return trainer.softmax_cross_entropy(model(tokens[:, :-1]),
                                             tokens[:, 1:])
    step, _, _ = trainer.make_gspmd_step(loss_fn, tx, mesh, specs,
                                         P("dp", None))
    toks = torch.from_numpy(_tokens()).long()
    losses = [step(model, tx, toks[i])[2].item() for i in range(STEPS)]
    whole = tpl_pipe.stack_pipeline_params(
        {n: p.full_tensor().detach() for n, p in model.named_parameters()},
        cfg.num_layers)
    params = {("layers", n): t.numpy() for n, t in whole["layers"].items()}
    params.update({n: t.numpy() for n, t in whole.items() if n != "layers"})
    return {"losses": losses, "params": params}


def _refusals_job(tree):
    """The step's two refusals that need a batch: rows the microbatches do
    not divide (dp2×pp2, 3 local rows for 2 microbatches) and a sequence
    sp does not divide (pp2×sp2 ring, 31 positions)."""
    out = {}
    for name, layout, impl, shape in (
            ("batch", dict(dp=2, pp=2), "flash", (6, 33)),
            ("sequence", dict(pp=2, sp=2), "ring", (4, 32))):
        cfg, mesh, placed, tx = _place(tree, layout, impl)
        step, _, _ = tpl_pipe.make_pipeline_step(cfg, tx, mesh, MICRO, placed)
        try:
            step(placed, tx, torch.zeros(shape, dtype=torch.long))
            out[name] = None
        except ValueError as exc:
            out[name] = str(exc)
    return out


def _worker(r, port, tree, results):
    torch.set_num_threads(1)   # four ranks share the host's cores
    report = {}
    try:
        mpi_ops.init(device="cpu", rank=r, size=WORLD,
                     init_method=f"tcp://localhost:{port}")
        jobs = {"gpipe": _gpipe_job, "gspmd": lambda: _gspmd_job(tree),
                "refusals": lambda: _refusals_job(tree)}
        for name, layout, impl, _ in LAYOUTS:
            jobs[name] = (lambda layout=layout, impl=impl:
                          _pipeline_job(tree, layout, impl))
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
    tree = _jax_params()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, tree, results))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        # the JAX side while the ranks run
        for name, layout, _, jimpl in LAYOUTS:
            _JAX[name] = _jax_pipeline(layout, jimpl)
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


# the JAX pipeline's (losses, params) by layout name, computed by the
# ``reports`` fixture
_JAX = {}


def _report(reports, name):
    for r in range(WORLD):
        assert not isinstance(reports[r][name], str), \
            f"rank {r}:\n{reports[r][name]}"
    return [reports[r][name] for r in range(WORLD)]


# ---------------------------------------------------------------------------
# gpipe


def _jax_gpipe(with_grad):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP
    from horovod_tpu.parallel import mesh as jmesh
    from horovod_tpu.parallel import pipeline as jpl
    w, x = (jnp.asarray(a) for a in _gpipe_inputs())
    mesh = jmesh.build_mesh(devices=jax.devices()[:G_STAGES], dp=1,
                            pp=G_STAGES)

    def pipe(w_local, x_all):
        out = jpl.gpipe(lambda a: jnp.tanh(a @ w_local[0]), x_all,
                        axis_name="pp")
        return jpl.last_stage_value(out, "pp")
    if not with_grad:
        return np.asarray(jax.jit(jax.shard_map(
            pipe, mesh=mesh, in_specs=(JP("pp"), JP()),
            out_specs=JP()))(w, x))

    def per_rank(w_local, x_all):
        return jax.grad(lambda a: jnp.sum(pipe(a, x_all) ** 2))(w_local)
    return np.asarray(jax.jit(jax.shard_map(
        per_rank, mesh=mesh, in_specs=(JP("pp"), JP()),
        out_specs=JP("pp")))(w, x))


def _serial():
    w, x = (torch.from_numpy(a).requires_grad_(True)
            for a in _gpipe_inputs())
    a = x
    for i in range(G_STAGES):
        a = torch.tanh(a @ w[i])
    (a ** 2).sum().backward()
    return a.detach().numpy(), w.grad.numpy(), x.grad.numpy()


class TestGpipePrimitive:
    def test_matches_serial_forward(self, hvd, reports):
        got = _report(reports, "gpipe")
        want, _, _ = _serial()
        for r in range(WORLD):    # every stage holds the last stage's value
            np.testing.assert_allclose(got[r]["out"], want, rtol=2e-5,
                                       atol=2e-6)
            assert got[r]["ticks"] == G_MICRO + G_STAGES - 1
        np.testing.assert_allclose(got[0]["out"], _jax_gpipe(False),
                                   rtol=2e-5, atol=2e-6)

    def test_matches_serial_gradient(self, hvd, reports):
        got = _report(reports, "gpipe")
        _, dw, dx = _serial()
        jdw = _jax_gpipe(True)
        for r in range(WORLD):
            np.testing.assert_allclose(got[r]["dw"], dw[r], rtol=2e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(got[r]["dw"], jdw[r], rtol=2e-4,
                                       atol=1e-5)
        # the microbatches' gradient lands on stage 0 alone
        np.testing.assert_allclose(got[0]["dx"], dx, rtol=2e-4, atol=1e-5)
        for r in range(1, WORLD):
            assert not got[r]["dx"].any()

    def test_bubble_ticks_get_zero_gradient(self, reports):
        got = _report(reports, "gpipe")
        for r in range(WORLD):
            assert got[r]["bubble_ticks"] == G_STAGES - 1
            assert got[r]["bubble_zero"], f"stage {r}"


# ---------------------------------------------------------------------------
# the stacked layout and its specs


def test_stack_unstack_roundtrip_matches_jax(hvd):
    from horovod_tpu.parallel import pipeline as jpl
    tree = _jax_params()
    cfg = _port_cfg()
    model = params_from_flax(tree, cfg, device="cpu")
    got = tpl_pipe.stack_pipeline_params(model, cfg.num_layers)
    want = jpl.stack_pipeline_params(tree, cfg.num_layers)
    assert set(got) == {"layers", "embed.weight", "ln_f.scale",
                        "lm_head.weight"}
    names = [("layers", n) for n in got["layers"]] + [
        n for n in got if n != "layers"]
    assert len(names) == len(tpl_pipe.pipeline_leaves(got))
    for name in names:
        path, transposed = _stacked_path(name, cfg)
        w = np.asarray(_leaf(want, path))
        a = _leaf(got, name if isinstance(name, tuple) else (name,)).numpy()
        np.testing.assert_array_equal(a.swapaxes(-1, -2) if transposed
                                      else a, w, err_msg=str(name))
    back = tpl_pipe.unstack_pipeline_params(got, cfg.num_layers)
    params = dict(model.named_parameters())
    assert set(back) == set(params)
    for n, t in back.items():
        assert torch.equal(t, params[n].detach()), n


@pytest.mark.parametrize("tp", [False, True])
def test_pipeline_param_specs_match_jax(hvd, tp):
    from horovod_tpu.parallel import pipeline as jpl
    tree = _jax_params()
    cfg = _port_cfg()
    jspecs = jpl.pipeline_param_specs(
        jpl.stack_pipeline_params(tree, cfg.num_layers), tp=tp)
    whole = tpl_pipe.stack_pipeline_params(
        params_from_flax(tree, cfg, device="cpu"), cfg.num_layers)
    got = tpl_pipe.pipeline_param_specs(whole, tp=tp)
    assert set(got) == set(whole) and set(got["layers"]) == set(
        whole["layers"])
    for name in [("layers", n) for n in got["layers"]] + [
            n for n in got if n != "layers"]:
        path, transposed = _stacked_path(name, cfg)
        key = name if isinstance(name, tuple) else (name,)
        spec = _leaf(got, key)
        ndim = _leaf(whole, key).dim()

        def pad(t):
            return (tuple(t) + (None,) * ndim)[:ndim]
        want = pad(_leaf(jspecs, path))
        if transposed:
            want = want[:-2] + want[-2:][::-1]
        assert isinstance(spec, P)
        assert pad(spec) == want, name


# ---------------------------------------------------------------------------
# the refusals


def _mesh(**layout):
    return tmesh.build_mesh(devices=list(range(WORLD)), **layout)


@pytest.mark.parametrize("case", ["layers", "experts", "tied"])
def test_refuses_as_jax(hvd, case):
    import jax
    import optax
    from horovod_tpu.models import transformer as jtr
    from horovod_tpu.parallel import mesh as jmesh
    from horovod_tpu.parallel import pipeline as jpl
    kw, layout, exc = {
        "layers": ({}, dict(pp=4), ValueError),
        "experts": (dict(num_experts=2), dict(pp=2, dp=2),
                    NotImplementedError),
        "tied": (dict(tie_embeddings=True), dict(pp=2, dp=2),
                 NotImplementedError)}[case]
    jcfg = jtr.TransformerConfig.tiny(**kw)
    jparams = jpl.stack_pipeline_params(_jax_params(), 2)
    with pytest.raises(exc) as jerr:
        jpl.make_pipeline_step(jcfg, optax.sgd(0.1), jmesh.build_mesh(
            devices=jax.devices()[:WORLD], **layout), 2, jparams)
    cfg = ttr.TransformerConfig.tiny(**kw)
    whole = tpl_pipe.stack_pipeline_params(
        params_from_flax(_jax_params(), _port_cfg(), device="cpu"), 2)
    with pytest.raises(exc) as err:
        tpl_pipe.make_pipeline_step(cfg, None, _mesh(**layout), 2, whole)
    # the same first sentence (the JAX text goes on about lax.scan)
    def first(msg):
        return msg.split(" (")[0].split(";")[0]
    assert first(str(err.value)) == first(str(jerr.value))


def test_refuses_indivisible_batch_and_sequence(reports):
    got = _report(reports, "refusals")
    for r in range(WORLD):
        assert got[r]["batch"] == (
            "local batch 3 not divisible by num_microbatches=2")
        assert got[r]["sequence"] == (
            "sequence length 31 not divisible by sp=2")


# ---------------------------------------------------------------------------
# the step


def _jax_pipeline(layout, impl):
    """Two JAX pipeline steps from the same init: (losses, params)."""
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu.models import transformer as jtr
    from horovod_tpu.parallel import mesh as jmesh
    from horovod_tpu.parallel import pipeline as jpl
    cfg = _jax_cfg(impl)
    mesh = jmesh.build_mesh(devices=jax.devices()[:WORLD], **layout)
    pparams = jpl.stack_pipeline_params(_jax_params(), cfg.num_layers)
    tx = optax.sgd(LR)
    step, pshard, bshard = jpl.make_pipeline_step(cfg, tx, mesh, MICRO,
                                                  pparams)
    pparams = jax.tree_util.tree_map(jax.device_put, pparams, pshard)
    opt_state = tx.init(pparams)
    toks = jnp.asarray(_tokens())
    losses = []
    for i in range(STEPS):
        pparams, opt_state, loss = step(pparams, opt_state,
                                        jax.device_put(toks[i], bshard))
        losses.append(float(loss))
    return losses, jax.device_get(pparams)


def _assert_against_jax(got, want_tree, label):
    cfg = _port_cfg()
    for name, a in got.items():
        path, transposed = _stacked_path(name, cfg)
        w = np.asarray(_leaf(want_tree, path))
        w = w.swapaxes(-1, -2) if transposed else w
        np.testing.assert_allclose(a, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"{label} {name}")


@pytest.mark.parametrize("name,layout,impl,jimpl", LAYOUTS)
def test_step_matches_jax_pipeline(hvd, reports, name, layout, impl, jimpl):
    got = _report(reports, name)
    for r in range(1, WORLD):   # every rank reports the same loss
        assert got[r]["losses"] == got[0]["losses"]
    assert got[0]["batch_spec"] == ("dp", None)
    if "tp" in layout:
        assert "tp" in got[0]["qkv_spec"]
    losses, params = _JAX[name]
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-5)
    _assert_against_jax(got[0]["params"], params, name)


@pytest.mark.parametrize("name", [n for n, _, _, _ in LAYOUTS])
def test_step_matches_unpipelined_gspmd(reports, name):
    got = _report(reports, name)[0]
    want = _report(reports, "gspmd")[0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for n, w in want["params"].items():
        np.testing.assert_allclose(got["params"][n], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"{name} {n}")
