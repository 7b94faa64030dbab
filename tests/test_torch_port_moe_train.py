"""``train_lm --num-experts --ep``: the MoE model trained on the ep mesh,
saved, and resumed at ep 2 and at ep 1.

Two CPU processes over gloo (``run(fn)``, negotiated) train the tiny
config with 4 experts at ep 2 for 4 steps and save after steps 2 and 4
(each expert stack gathered whole over 'ep', the layout in the
manifest), with ``--checkpoint-digest``. The save of step 2 (a copy of
the directory without step 4) is then
  * resumed at ep 2: the losses of steps 3-4 bit-equal to an
    uninterrupted ep-2 run of 4 steps;
  * resumed at ep 1 (dp 2) through ``restore_on_mesh``: the restored
    state's digest equal to the saved one (the restore is exact across
    layouts), the losses of steps 3-4 within 2^-8 of the uninterrupted
    run's (the tiny config computes in bf16, where the two layouts sum in
    another order: a dense dp-2 and tp-2 run differ by 4e-4 at step 1).
Every run's losses are finite and the same on both ranks.
"""

import math
import os
import shutil

import pytest

from horovod_tpu_torch.run.launch import run
from horovod_tpu_torch.utils import checkpoint as tckpt

RUN_TIMEOUT_S = 180.0
ARGS = ["--device", "cpu", "--num-experts", "4", "--checkpoint-every", "2",
        "--checkpoint-digest"]

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
    # two ranks share the host's cores
    return run(_train_job(), args=(argv,), num_proc=2,
               start_timeout_s=RUN_TIMEOUT_S,
               env={"OMP_NUM_THREADS": "2"})


def _losses(events):
    return {e["step"]: e["loss"] for e in events if e["event"] == "step"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("moe_ckpt")
    saved = base / "ep2"
    got = {"saved": saved,
           "full": _train(ARGS + ["--ep", "2", "--steps", "4",
                                  "--checkpoint-dir", str(saved)])}
    for name, flag in (("ep2", "--ep"), ("ep1", "--dp")):
        d = base / f"resume_{name}"
        shutil.copytree(saved, d)
        shutil.rmtree(d / f"step-{4:010d}")   # resume from step 2
        got[name] = _train(ARGS + [flag, "2", "--steps", "4",
                                   "--checkpoint-dir", str(d)])
    return got


def test_save_records_the_ep_layout(runs):
    assert tckpt.saved_layout(str(runs["saved"]), 2)["ep"] == 2
    assert tckpt.latest_step(str(runs["saved"])) == 4


def test_losses_finite_and_equal_on_both_ranks(runs):
    for name in ("full", "ep2", "ep1"):
        done = [e for events in runs[name] for e in events
                if e["event"] == "done"]
        assert len(done) == 2 and done[0]["losses"] == done[1]["losses"]
        assert all(map(math.isfinite, done[0]["losses"]))


def test_resume_at_ep2_bit_equal_to_uninterrupted(runs):
    resumed = [e for e in runs["ep2"][0] if e["event"] == "resume"]
    assert resumed and resumed[0]["step"] == 2
    assert resumed[0]["saved_layout"]["ep"] == 2
    got, full = _losses(runs["ep2"][0]), _losses(runs["full"][0])
    assert sorted(got) == [3, 4]
    for s in (3, 4):
        assert got[s] == full[s], (s, got[s], full[s])


def test_resume_at_ep1_restores_the_saved_state(runs):
    saves = [e for e in runs["full"][0]
             if e["event"] == "save" and e["step"] == 2]
    resumed = [e for e in runs["ep1"][0] if e["event"] == "resume"]
    assert saves and resumed
    assert resumed[0]["extra"] == {"step": 2, "data_pos": 2, "adam_step": 2}
    assert resumed[0]["digest"] == saves[0]["digest"]
    got, full = _losses(runs["ep1"][0]), _losses(runs["full"][0])
    assert sorted(got) == [3, 4]
    for s in (3, 4):
        assert abs(got[s] - full[s]) <= 2 ** -8, (s, got[s], full[s])
