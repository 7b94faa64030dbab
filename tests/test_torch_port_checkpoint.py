"""horovod_tpu_torch's checkpoint plane (``utils/checkpoint.py``,
``trainer.Checkpointer``) against ``horovod_tpu.utils.checkpoint``.

Mirrors ``tests/test_checkpoint.py`` on torch trees (format 1 round
trips, the crash-window ``.old`` fallback, structure mismatches, and
``CheckpointManager``: extra, latest-wins async saves, retention, sharded
saves resharded into any world, the commit barrier, corruption, verify,
writer errors and the 7-point save-interruption torture matrix). Then
across the packages, both formats, both directions: the JAX package
writes and the port restores, the port writes and the JAX package
restores, bit-equal, with bfloat16 leaves (which ``np.load`` gives back
as 2-byte void arrays, as the first test pins down) and the same leaf
names and manifests. A checkpoint two ranks wrote (a process each)
restores on one. ``trainer.Checkpointer`` in a subprocess: SIGTERM in
the middle of a step, the step finishes, an emergency save commits and
the process exits 45; the next run resumes from it.
"""

import io
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from horovod_tpu_torch.common.exceptions import (CheckpointError,
                                                 CorruptCheckpointError)
from horovod_tpu_torch.utils import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPROCESS_TIMEOUT_S = 60


def _tree(k=0):
    return {"w": torch.arange(6.0).reshape(2, 3) + k,
            "opt": {"m": torch.ones(4) + k, "v": torch.full((4,), 0.5) + k},
            "step_scale": torch.tensor(1.5)}


def _like():
    return _tree(0)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# format 1


def test_save_restore_roundtrip(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3),
            "nested": {"b": torch.ones(4), "s": torch.tensor(2.5)}}
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, tree, step=7)
    assert checkpoint.exists(path)
    assert checkpoint.latest_step(path) == 7
    restored, step = checkpoint.restore(path, like=tree)
    assert step == 7
    _eq(restored["w"], np.arange(6.0).reshape(2, 3))
    _eq(restored["nested"]["b"], np.ones(4))
    assert isinstance(restored["w"], torch.Tensor)


def test_save_is_atomic_overwrite(tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, {"x": torch.zeros(2)}, step=1)
    checkpoint.save(path, {"x": torch.ones(2)}, step=2)
    restored, step = checkpoint.restore(path, like={"x": torch.zeros(2)})
    assert step == 2
    _eq(restored["x"], np.ones(2))
    assert not [d for d in os.listdir(tmp_path)
                if d.startswith(".ckpt-tmp")]


def test_restore_falls_back_to_old_after_interrupted_overwrite(tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, {"x": torch.full((2,), 1.0)}, step=1)
    os.replace(path, path + ".old")
    assert checkpoint.exists(path)
    restored, step = checkpoint.restore(path, like={"x": torch.zeros(2)})
    assert step == 1
    _eq(restored["x"], np.full(2, 1.0))
    assert checkpoint.latest_step(path) == 1
    assert checkpoint.latest_step(str(tmp_path / "nothing")) is None


def test_restore_like_mismatch_fails_loud(tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, {"w": torch.zeros(2), "b": torch.ones(3)}, step=1)
    with pytest.raises(CheckpointError, match="mismatch") as ei:
        checkpoint.restore(path, like={"w": torch.zeros(2),
                                       "extra_head": torch.zeros(4)})
    assert "extra_head" in str(ei.value) and "b" in str(ei.value)
    raw, step = checkpoint.restore(path)
    assert step == 1 and sorted(raw) == ["['b']", "['w']"]


# ---------------------------------------------------------------------------
# CheckpointManager (format 2)


def test_manager_sync_roundtrip_with_extra(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "c"), async_save=False)
    d = mgr.save(_tree(), step=12, extra={"data_pos": 12, "rng": [0, 7]})
    assert os.path.exists(os.path.join(d, "manifest.json"))
    assert mgr.latest_step() == 12
    tree, step, extra = mgr.restore(like=_like())
    assert step == 12 and extra == {"data_pos": 12, "rng": [0, 7]}
    _eq(tree["opt"]["v"], np.full(4, 0.5))
    tree2, step2 = checkpoint.restore(str(tmp_path / "c"), like=_like())
    assert step2 == 12
    _eq(tree2["w"], _tree()["w"])
    assert mgr.stats["saves"] == 1 and mgr.stats["block_s"] >= 0
    mgr.close()


def test_manager_async_drains_and_drops_stale_snapshots(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "c"), keep=0)
    assert mgr.async_save
    gate, entered = threading.Event(), threading.Event()

    def stall():
        entered.set()
        gate.wait()
    checkpoint._FAILPOINTS["pre_shard"] = stall
    try:
        mgr.save(_tree(1), step=1)
        # the writer holds step 1 before the others queue (a host copy of
        # a torch tree is fast enough to outrun the writer's start)
        assert entered.wait(30)
        for s in range(2, 6):
            mgr.save(_tree(s), step=s)
    finally:
        checkpoint._FAILPOINTS.clear()
        gate.set()
    mgr.wait(timeout=30)
    mgr.close()
    committed = sorted(checkpoint._committed_steps(str(tmp_path / "c")))
    assert committed[-1] == 5
    assert 2 <= len(committed) <= 3
    assert mgr.stats["dropped"] >= 2
    tree, step, _ = checkpoint.CheckpointManager(
        str(tmp_path / "c")).restore(like=_like())
    assert step == 5
    _eq(tree["opt"]["m"], np.ones(4) + 5)


def test_manager_retention_keeps_last_k(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "c"), keep=2,
                                       async_save=False)
    for s in (3, 7, 11, 15):
        mgr.save(_tree(s), step=s)
    mgr.close()
    assert sorted(checkpoint._committed_steps(str(tmp_path / "c"))) == \
        [11, 15]
    with pytest.raises(FileNotFoundError, match=r"\[11, 15\]"):
        checkpoint.restore(str(tmp_path / "c"), like=_like(), step=3)


def _save_as_ranks(root, world, tree, step, extra=None, **kw):
    mgrs = [checkpoint.CheckpointManager(root, rank=r, world_size=world,
                                         async_save=False, **kw)
            for r in range(world)]
    errs = []

    def run(m):
        try:
            m.save(tree, step=step, extra=extra)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)
    threads = [threading.Thread(target=run, args=(m,)) for m in mgrs[1:]]
    for t in threads:
        t.start()
    mgrs[0].save(tree, step=step, extra=extra)
    for t in threads:
        t.join()
    assert not errs


def test_manager_sharded_save_reshards_into_any_world(tmp_path):
    root = str(tmp_path / "c")
    _save_as_ranks(root, 3, _tree(2), 4, extra={"data_pos": 4})
    d = checkpoint._committed_steps(root)[4]
    assert len([f for f in os.listdir(d) if f.endswith(".npz")]) == 3
    for world in (1, 2, 5):
        mgr = checkpoint.CheckpointManager(root, rank=0, world_size=world)
        tree, step, extra = mgr.restore(like=_like())
        assert step == 4 and extra == {"data_pos": 4}
        _eq(tree["w"], _tree(2)["w"])
        _eq(tree["opt"]["v"], _tree(2)["opt"]["v"])


def test_manager_commit_waits_for_all_ranks(tmp_path):
    root = str(tmp_path / "c")
    mgr0 = checkpoint.CheckpointManager(root, rank=0, world_size=2,
                                        async_save=False,
                                        commit_timeout_s=0.3)
    with pytest.raises(CheckpointError, match="never appeared"):
        mgr0.save(_tree(), step=1)
    assert not checkpoint._committed_steps(root)
    assert not checkpoint.exists(root)


def test_manager_corruption_fails_loud(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "c"), async_save=False)
    d = mgr.save(_tree(), step=2)
    shard = os.path.join(d, "rank00000.npz")
    blob = bytearray(open(shard, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(shard, "wb") as f:
        f.write(blob)
    with pytest.raises(CorruptCheckpointError, match="checksum"):
        mgr.restore(like=_like())
    with open(shard, "wb") as f:
        f.write(blob[:-10])
    with pytest.raises(CorruptCheckpointError, match="bytes"):
        mgr.restore(like=_like())


def test_manager_verify_false_skips_checksums(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "c"), async_save=False)
    d = mgr.save(_tree(), step=2)
    mpath = os.path.join(d, "manifest.json")
    manifest = json.load(open(mpath))
    manifest["files"]["rank00000.npz"]["crc"] ^= 1
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CorruptCheckpointError, match="checksum"):
        mgr.restore(like=_like())
    tree, step, _ = mgr.restore(like=_like(), verify=False)
    assert step == 2
    _eq(tree["w"], _tree()["w"])


def test_manager_v2_like_mismatch_fails_loud(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "c"),
                                       async_save=False)
    mgr.save(_tree(), step=1)
    with pytest.raises(CheckpointError, match="mismatch"):
        mgr.restore(like={"w": torch.zeros(2, 3)})


def test_manager_async_writer_error_reaches_the_train_loop(tmp_path):
    def boom():
        raise OSError(28, "No space left on device")

    mgr = checkpoint.CheckpointManager(str(tmp_path / "c"))
    checkpoint._FAILPOINTS["pre_commit"] = boom
    try:
        mgr.save(_tree(), step=1)
        with pytest.raises(CheckpointError, match="No space left"):
            mgr.wait(timeout=30)
    finally:
        checkpoint._FAILPOINTS.clear()
    mgr.close()


_POINTS = {  # failpoint -> the step restore() must see afterwards
    "pre_shard": 1, "post_shard": 1, "pre_rank_manifest": 1,
    "post_rank_manifest": 1, "pre_commit": 1, "mid_commit": 1,
    "post_commit": 2,
}


class _Torture(RuntimeError):
    pass


@pytest.mark.parametrize("point", sorted(_POINTS))
def test_torture_save_interrupted_at_every_point(tmp_path, point):
    root = str(tmp_path / "c")
    mgr = checkpoint.CheckpointManager(root, async_save=False, keep=4)
    mgr.save(_tree(1), step=1)

    def boom():
        raise _Torture(point)

    checkpoint._FAILPOINTS[point] = boom
    try:
        with pytest.raises(_Torture):
            mgr.save(_tree(2), step=2)
    finally:
        checkpoint._FAILPOINTS.clear()
    want = _POINTS[point]
    tree, step, _ = mgr.restore(like=_like(), verify=True)
    assert step == want
    _eq(tree["w"], _tree(want)["w"])
    for s, d in checkpoint._committed_steps(root).items():
        checkpoint._verify_files(d, checkpoint._read_global_manifest(d))
    mgr.save(_tree(3), step=3)
    tree, step, _ = mgr.restore(like=_like(), verify=True)
    assert step == 3
    committed = checkpoint._committed_steps(root)
    for name in os.listdir(root):
        if name.startswith("step-"):
            assert int(name.split("-")[1]) in committed, \
                f"uncommitted partial {name} survived GC"
    mgr.close()


# ---------------------------------------------------------------------------
# across the packages


def test_np_load_gives_bf16_leaves_back_as_two_byte_voids():
    """What the JAX package's np.savez makes of an ml_dtypes bfloat16 leaf,
    and what the port writes for torch's: the same bytes, descr '<V2'."""
    import jax.numpy as jnp
    a = np.asarray(jnp.arange(5, dtype=jnp.bfloat16))
    f = io.BytesIO()
    np.savez(f, x=a)
    f.seek(0)
    back = np.load(f)["x"]
    assert back.dtype == np.dtype("V2")
    host = checkpoint._to_host(torch.arange(5).to(torch.bfloat16))
    assert host.dtype == np.dtype("V2")
    assert host.tobytes() == a.tobytes() == back.tobytes()
    t = checkpoint._as_torch(back)
    assert t.dtype == torch.bfloat16 and t.tolist() == [0, 1, 2, 3, 4]


def _jax_tree(k=0):
    import jax.numpy as jnp
    return {"w": jnp.arange(6.0).reshape(2, 3) + k,
            "opt": {"mu": (jnp.arange(4) + k).astype(jnp.bfloat16),
                    "nu": [jnp.full((3,), 0.25 + k), jnp.zeros(2)]},
            "s": jnp.float32(2.5 + k)}


def _torch_tree(k=0):
    return {"w": torch.arange(6.0).reshape(2, 3) + k,
            "opt": {"mu": (torch.arange(4) + k).to(torch.bfloat16),
                    "nu": [torch.full((3,), 0.25 + k), torch.zeros(2)]},
            "s": torch.tensor(2.5 + k)}


def _same(jtree, ttree):
    from horovod_tpu.utils import checkpoint as jc
    jn, jl = jc._flatten_with_names(jtree)
    tn, tl = checkpoint._flatten_with_names(ttree)
    assert jn == tn
    for j, t in zip(jl, tl):
        j = np.asarray(j)
        t = checkpoint._to_host(t)
        assert j.tobytes() == t.tobytes() and j.shape == t.shape


@pytest.mark.parametrize("fmt", [1, 2])
def test_jax_writes_the_port_restores(tmp_path, fmt):
    from horovod_tpu.utils import checkpoint as jc
    path = str(tmp_path / "c")
    if fmt == 1:
        jc.save(path, _jax_tree(3), step=9)
        tree, step = checkpoint.restore(path, like=_torch_tree())
        extra = {}
    else:
        jc.CheckpointManager(path, async_save=False).save(
            _jax_tree(3), 9, extra={"data_pos": 9})
        tree, step, extra = checkpoint.CheckpointManager(path).restore(
            like=_torch_tree())
        assert extra == {"data_pos": 9}
    assert step == 9
    assert tree["opt"]["mu"].dtype == torch.bfloat16
    _same(_jax_tree(3), tree)


@pytest.mark.parametrize("fmt", [1, 2])
def test_the_port_writes_jax_restores(tmp_path, fmt):
    from horovod_tpu.utils import checkpoint as jc
    path = str(tmp_path / "c")
    if fmt == 1:
        checkpoint.save(path, _torch_tree(4), step=11)
        tree, step = jc.restore(path, like=_jax_tree())
    else:
        checkpoint.CheckpointManager(path, async_save=False).save(
            _torch_tree(4), 11, extra={"data_pos": 11})
        tree, step, extra = jc.CheckpointManager(path).restore(
            like=_jax_tree())
        assert extra == {"data_pos": 11}
    assert step == 11
    _same(tree, _torch_tree(4))
    # the manifests name the same leaves in the same order
    if fmt == 1:
        manifest = json.load(open(os.path.join(path, "manifest.json")))
        jc.save(str(tmp_path / "j"), _jax_tree(4), step=11)
        jmanifest = json.load(open(os.path.join(str(tmp_path / "j"),
                                                "manifest.json")))
        assert manifest == jmanifest


def test_two_ranks_write_one_restores(tmp_path):
    """Two processes, one manager each (rank 0 commits after rank 1's
    manifest), then one process restores the whole tree, bit-equal to
    what the saving ranks hashed."""
    root = str(tmp_path / "c")
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, {root!r})\n"
        "from horovod_tpu_torch.utils import checkpoint\n"
        "from test_torch_port_checkpoint import _torch_tree\n"
        "m = checkpoint.CheckpointManager({dir!r}, rank={r}, world_size=2,"
        " async_save=False)\n"
        "m.save(_torch_tree(5), 6, extra={{'data_pos': 6}})\n"
        "print(checkpoint.tree_digest(_torch_tree(5)))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests")]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(root=os.path.join(ROOT, "tests"),
                                           dir=root, r=r)],
        stdout=subprocess.PIPE, text=True, env=env) for r in range(2)]
    digests = [p.communicate(timeout=SUBPROCESS_TIMEOUT_S)[0].strip()
               for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    d = checkpoint._committed_steps(root)[6]
    assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == \
        ["rank00000.npz", "rank00001.npz"]
    tree, step, extra = checkpoint.CheckpointManager(root).restore(
        like=_torch_tree())
    assert step == 6 and extra == {"data_pos": 6}
    assert digests[0] == digests[1] == str(checkpoint.tree_digest(tree))


_PREEMPT = """
import os, signal, sys, torch
from horovod_tpu_torch import trainer
ckpt = trainer.Checkpointer({dir!r}, every=100)
w = torch.zeros(3)
state, start, extra = ckpt.resume(like={{"w": w}})
w = state["w"].clone()
print("start", start, extra, flush=True)
for i in range(start, 1000):
    if i == start + 2:
        os.kill(os.getpid(), signal.SIGTERM)   # in the middle of a step
    w += 1.0
    if ckpt.step_end(i + 1, {{"w": w}}, extra={{"data_pos": i + 1}}):
        print("preempted", i + 1, flush=True)
        sys.exit(trainer.PREEMPTED_EXIT_CODE)
"""


def test_checkpointer_sigterm_saves_and_exits_45(tmp_path):
    path = str(tmp_path / "c")
    code = _PREEMPT.format(dir=path)
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=SUBPROCESS_TIMEOUT_S)
    assert run.returncode == 45, run.stderr
    assert "start 0 {}" in run.stdout and "preempted 3" in run.stdout
    tree, step, extra = checkpoint.restore_with_extra(
        path, like={"w": torch.zeros(3)})
    assert step == 3 and extra == {"data_pos": 3}
    _eq(tree["w"], np.full(3, 3.0))
    again = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, env=env, timeout=SUBPROCESS_TIMEOUT_S)
    assert again.returncode == 45, again.stderr
    assert "start 3 {'data_pos': 3}" in again.stdout
    assert "preempted 6" in again.stdout
    _eq(checkpoint.restore(path, like={"w": torch.zeros(3)})[0]["w"],
        np.full(3, 6.0))
