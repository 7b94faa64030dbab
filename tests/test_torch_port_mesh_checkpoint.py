"""Checkpointing on the tp mesh: ``train_lm --steps --checkpoint-dir`` at
tp 2, resumed at tp 2 and at another layout.

Two CPU processes over gloo (``run(fn)``, negotiated) train the tiny
config at tp 2 for 3 steps and save (each leaf gathered whole, each
rank writing the leaves it owns, the layout in the manifest). The save
is then
  * resumed at tp 2: losses of steps 4-6 bit-equal to an uninterrupted
    tp 2 run of 6 steps;
  * resumed at dp 2: the same losses within 2^-8 (the sums are taken
    in another order);
  * restored at dp 2 (two processes) and at tp 1 (this process) through
    the port's ``restore_on_mesh`` and held against the JAX package's
    restore of the same files placed on a dp-2 mesh (its
    ``restore_on_mesh`` steps, with its bf16 voids viewed as bfloat16):
    every leaf bit-equal, the step counter and the data cursor the
    same.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from horovod_tpu_torch.run.launch import run
from horovod_tpu_torch.utils import checkpoint as tckpt

RUN_TIMEOUT_S = 180.0
ARGS = ["--device", "cpu", "--checkpoint-every", "3"]

# another test file in the same worker may leave HOROVOD_MESH* set, and
# train_lm.main with no layout flag builds its mesh from them
_MESH_ENV = ("HOROVOD_MESH", "HOROVOD_MESH_TP", "HOROVOD_MESH_SP",
             "HOROVOD_MESH_PP", "HOROVOD_MESH_EP")


@pytest.fixture(autouse=True, scope="module")
def _no_mesh_env():
    saved = {k: os.environ.pop(k) for k in _MESH_ENV if k in os.environ}
    yield
    os.environ.update(saved)


def _train_job():
    def fn(argv):
        import contextlib
        import io
        import json
        from horovod_tpu_torch import train_lm
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_lm.main(argv)
        return [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]
    return fn


def _train(argv):
    events = run(_train_job(), args=(argv,), num_proc=2,
                 start_timeout_s=RUN_TIMEOUT_S)
    return events[0]   # rank 0 prints the step events


def _losses(events):
    return {e["step"]: e["loss"] for e in events if e["event"] == "step"}


def _restore_job():
    def fn(directory, layout):
        import numpy as np
        import torch
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import train_lm, trainer
        from horovod_tpu_torch.parallel import mesh as mesh_lib
        from horovod_tpu_torch.utils import checkpoint as ck
        hvd.init(device="cpu")
        mesh = mesh_lib.set_global_mesh(mesh_lib.build_mesh(**layout))
        cfg = train_lm.flagship_config(False)
        model, opt, _, _ = train_lm.build_gspmd_step(
            cfg, 2, 64, 1, torch.device("cpu"), mesh)
        ckptr = trainer.Checkpointer(directory, rank=hvd.rank(),
                                     world_size=hvd.size(),
                                     preemption=False)
        tree, step, extra = ckptr.resume(
            like=train_lm.state_tree(model, opt), mesh=mesh,
            spec_tree=train_lm.state_specs(model, opt))
        train_lm.load_state(model, opt, tree, extra)
        names, leaves = ck._flatten_with_names(
            train_lm.state_tree(model, opt))
        out = {n: (t.view(torch.int16).numpy() if t.dtype ==
                   torch.bfloat16 else t.numpy()).copy()
               for n, t in zip(names, leaves)}
        mesh_lib.reset_global_mesh()
        hvd.shutdown()
        return out, step, extra
    return fn


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh_ckpt")
    saved = base / "tp2"
    _train(ARGS + ["--tp", "2", "--steps", "3",
                   "--checkpoint-dir", str(saved)])
    got = {"saved": saved}
    full = _train(ARGS + ["--tp", "2", "--steps", "6",
                          "--checkpoint-dir", str(base / "full")])
    got["full"] = _losses(full)
    for layout in ("tp", "dp"):
        d = base / f"resume_{layout}"
        shutil.copytree(saved, d)
        got[layout] = _train(ARGS + [f"--{layout}", "2", "--steps", "6",
                                     "--checkpoint-dir", str(d)])
    got["dp2_restore"] = run(_restore_job(), args=(str(saved), {"dp": 2}),
                             num_proc=2, start_timeout_s=RUN_TIMEOUT_S)
    return got


def test_save_records_the_tp_layout(runs):
    assert tckpt.saved_layout(str(runs["saved"]))["tp"] == 2
    assert tckpt.latest_step(str(runs["saved"])) == 3


def test_resume_at_tp2_bit_equal_to_uninterrupted(runs):
    resumed = [e for e in runs["tp"] if e["event"] == "resume"]
    assert resumed and resumed[0]["step"] == 3
    assert resumed[0]["saved_layout"]["tp"] == 2
    got = _losses(runs["tp"])
    assert sorted(got) == [4, 5, 6]
    for s in (4, 5, 6):
        assert got[s] == runs["full"][s], (s, got[s], runs["full"][s])


def test_resume_at_dp2_within_2_to_the_minus_8(runs):
    resumed = [e for e in runs["dp"] if e["event"] == "resume"]
    assert resumed and resumed[0]["extra"] == {"step": 3, "data_pos": 3,
                                               "adam_step": 3}
    got = _losses(runs["dp"])
    for s in (4, 5, 6):
        assert abs(got[s] - runs["full"][s]) <= 2 ** -8, \
            (s, got[s], runs["full"][s])


def _nest(flat):
    """{"['a']['b']": leaf} -> {"a": {"b": leaf}}."""
    import re
    out = {}
    for name, leaf in flat.items():
        keys = re.findall(r"\['(.*?)'\]", name)
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{path}[{k!r}]"))
        return out
    return {path: tree}


@pytest.fixture(scope="module")
def reference(runs):
    """The JAX package's restore_on_mesh of the same files, on a dp-2
    mesh: {name: numpy}, step, extra."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel import mesh as jmesh
    from horovod_tpu.utils import checkpoint as jckpt
    raw = tckpt.restore(str(runs["saved"]))[0]
    like = _nest({n: np.zeros(tuple(t.shape), jnp.bfloat16
                              if t.dtype == torch.bfloat16
                              else t.numpy().dtype)
                  for n, t in raw.items()})
    specs = jax.tree_util.tree_map(lambda _: P(), like)
    mesh = jmesh.build_mesh(dp=2, devices=jax.devices()[:2])
    # restore_on_mesh is restore_with_extra, then device_put_tree; the
    # JAX package hands device_put its bf16 leaves as the 2-byte voids
    # np.load gives back, which JAX refuses (ROADMAP.md §C, not a fault
    # of the port), so the voids are viewed as bfloat16 between the two
    tree, step, extra = jckpt.restore_with_extra(str(runs["saved"]), like)
    tree = jax.tree_util.tree_map(
        lambda a: a.view(jnp.bfloat16) if a.dtype.kind == "V" else a, tree)
    tree = jmesh.device_put_tree(tree, specs, mesh)
    assert jckpt.saved_layout(str(runs["saved"]))["tp"] == 2
    return ({n: np.asarray(v) for n, v in _flat(tree).items()}, step,
            extra)


def _bits(a):
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind not in "iu":
        return a.view(np.int16)
    return a


def _same_leaves(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(_bits(got[n]), _bits(want[n]),
                                      err_msg=n)


def test_restore_at_dp2_bit_equal_to_the_reference(runs, reference):
    want, wstep, wextra = reference
    for leaves, step, extra in runs["dp2_restore"]:
        _same_leaves(leaves, want)
        assert step == wstep == 3
        assert extra["step"] == wextra["step"] == 3
        assert extra["data_pos"] == wextra["data_pos"] == 3


def test_restore_at_tp1_bit_equal_to_the_reference(runs, reference):
    want, wstep, wextra = reference
    leaves, step, extra = _restore_job()(str(runs["saved"]), {"dp": 1})
    _same_leaves(leaves, want)
    assert (step, extra["data_pos"]) == (wstep, wextra["data_pos"])


def test_whole_leaves_gathered_before_the_save(runs):
    """Every rank's shard file holds whole leaves: the raw restore has
    each leaf at its unsharded shape."""
    from horovod_tpu_torch.models import transformer as tr
    from horovod_tpu_torch.train_lm import flagship_config
    raw = tckpt.restore(str(runs["saved"]))[0]
    model = tr.init_params(flagship_config(False),
                           torch.Generator().manual_seed(0), train=True,
                           device="cpu")
    for n, p in model.named_parameters():
        assert tuple(raw[f"['params'][{n!r}]"].shape) == tuple(p.shape), n
