"""horovod_tpu_torch's fleet plane against the JAX package's.

The cases of tests/test_fleet.py, each driven through both packages by one
script on the same seeded inputs (numpy trees for the pointer, publisher
and subscriber cases): the publication pointer (newest commit, signature,
scan fallback, the GC-unlink retry, never a format-1 checkpoint), the
publisher's monotonic generations and its metrics, and the subscriber's
state machine (arm, refuse corrupt and mismatched generations, latest
wins). Both packages must report the same steps, generations, refusals,
events and metric values.

Across the packages: a pointer written by either is read by the other
(and restores the same leaves), and the pointer JSON each writes for the
same manifest is byte-equal.

The engine hot swap on the tiny fp32 LM (the JAX engine's checkpoint
converted with ``params_from_flax``): a request in flight across a
mid-stream swap finishes on its admit-time weights and a post-swap
request runs on the new ones, token for token equal to the JAX engine's
tokens; ``fleet_swap``, ``serve_admit`` and ``serve_retire`` carry the
same generations; and the same swap on a tp-2 engine of two thread ranks
gives the unsharded engine's tokens.
"""

import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.serving.decode import model_from_tree, serving_tree

PROMPT = (1, 2, 3, 4, 5, 6)
N_OLD, N_NEW = 20, 8


class Pkg:
    """One package's fleet-plane surface, by name."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            from horovod_tpu.common import exceptions
            from horovod_tpu.fleet import WeightPublisher, WeightSubscriber
            from horovod_tpu.serving import queue
            from horovod_tpu.utils import checkpoint, metrics, tracing
        else:
            from horovod_tpu_torch.common import exceptions
            from horovod_tpu_torch.fleet import (WeightPublisher,
                                                 WeightSubscriber)
            from horovod_tpu_torch.serving import queue
            from horovod_tpu_torch.utils import checkpoint, metrics, tracing
        self.exceptions = exceptions
        self.WeightPublisher = WeightPublisher
        self.WeightSubscriber = WeightSubscriber
        self.queue = queue
        self.checkpoint = checkpoint
        self.metrics = metrics
        self.tracing = tracing

    def manager(self, directory, publish=True):
        mgr = self.checkpoint.CheckpointManager(
            str(directory), rank=0, world_size=1, async_save=False)
        pub = None
        if publish:
            pub = self.WeightPublisher(str(directory))
            mgr.on_commit = pub.publish
        return mgr, pub

    def subscriber(self, directory, like, **kw):
        kw.setdefault("poll_interval_s", 0.0)
        kw.setdefault("device_put", False)
        return self.WeightSubscriber(str(directory), like=like, **kw)


def _value(snap, name, **labels):
    fam = snap["metrics"].get(name)
    if fam is None:
        return None
    for v in fam["values"]:
        if all(v["labels"].get(k) == lv for k, lv in labels.items()):
            return v.get("value", v.get("count"))
    return None


def _events(snap, kind, keys):
    return [{k: e[k] for k in keys} for e in snap["events"]
            if e["event"] == kind]


def _both(tmp_path, scenario):
    """``scenario(pkg, directory)`` for each package, each with a fresh
    registry and directory; returns {name: record}."""
    out = {}
    for name in ("jax", "torch"):
        pkg = Pkg(name)
        pkg.metrics.reset(enabled=True)
        d = tmp_path / name
        d.mkdir()
        try:
            out[name] = scenario(pkg, d)
        finally:
            pkg.metrics.reset()
    return out


def _same(records):
    assert records["torch"] == records["jax"]
    return records["torch"]


def _arr(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# the publication pointer
# ---------------------------------------------------------------------------

class TestLatestManifest:
    def test_empty_directory_is_none(self, tmp_path):
        rec = _same(_both(tmp_path, lambda pkg, d: (
            pkg.checkpoint.latest_manifest(str(d)),
            pkg.checkpoint.manifest_signature(str(d)))))
        assert rec == (None, None)

    def test_pointer_names_newest_commit(self, tmp_path):
        def scenario(pkg, d):
            mgr, _ = pkg.manager(d)
            tree = {"w": np.arange(6, dtype=np.float32)}
            mgr.save(tree, 3, block=True)
            mgr.save(tree, 7, block=True)
            mgr.close()
            step, sd, m = pkg.checkpoint.latest_manifest(str(d))
            return (step, os.path.basename(sd), m["generation"], m["dir"],
                    sorted(m["files"]))
        step, base, gen, sdir, files = _same(_both(tmp_path, scenario))
        assert (step, base, gen, sdir) == (7, "step-0000000007", 2,
                                           "step-0000000007")
        assert files

    def test_signature_changes_on_republish(self, tmp_path):
        def scenario(pkg, d):
            mgr, _ = pkg.manager(d)
            tree = {"w": np.arange(6, dtype=np.float32)}
            mgr.save(tree, 1, block=True)
            sig1 = pkg.checkpoint.manifest_signature(str(d))
            mgr.save(tree, 2, block=True)
            mgr.close()
            return (sig1 is not None,
                    pkg.checkpoint.manifest_signature(str(d)) != sig1)
        assert _same(_both(tmp_path, scenario)) == (True, True)

    def test_scan_fallback_without_pointer(self, tmp_path):
        def scenario(pkg, d):
            mgr, _ = pkg.manager(d, publish=False)
            mgr.save({"w": np.ones(3, np.float32)}, 5, block=True)
            mgr.close()
            step, _d, m = pkg.checkpoint.latest_manifest(str(d))
            return step, "generation" in m
        assert _same(_both(tmp_path, scenario)) == (5, False)

    def test_scan_retries_gc_unlink_race(self, tmp_path, monkeypatch):
        def scenario(pkg, d):
            mgr, _ = pkg.manager(d, publish=False)
            mgr.save({"w": np.ones(3, np.float32)}, 5, block=True)
            mgr.close()
            real = pkg.checkpoint._read_global_manifest
            calls = []

            def flaky(sd):
                if not calls:
                    calls.append(1)
                    err = pkg.exceptions.CorruptCheckpointError(
                        "vanished under the reader")
                    err.__cause__ = FileNotFoundError(sd)
                    raise err
                return real(sd)

            monkeypatch.setattr(pkg.checkpoint, "_read_global_manifest",
                                flaky)
            try:
                step, _d, _m = pkg.checkpoint.latest_manifest(str(d))
            finally:
                monkeypatch.setattr(pkg.checkpoint,
                                    "_read_global_manifest", real)
            return step, len(calls)
        assert _same(_both(tmp_path, scenario)) == (5, 1)

    def test_pointer_is_not_a_legacy_checkpoint(self, tmp_path):
        def scenario(pkg, d):
            mgr, _ = pkg.manager(d)
            mgr.save({"w": np.ones(3, np.float32)}, 1, block=True)
            mgr.close()
            tree, step = pkg.checkpoint.restore(str(d))
            return (pkg.checkpoint._legacy_dir(str(d)), step, len(tree))
        assert _same(_both(tmp_path, scenario)) == (None, 1, 1)


class TestWeightPublisher:
    def test_generations_are_monotonic_across_restart(self, tmp_path):
        def scenario(pkg, d):
            mgr, pub = pkg.manager(d)
            tree = {"w": np.arange(4, dtype=np.float32)}
            mgr.save(tree, 1, block=True)
            mgr.save(tree, 2, block=True)
            mgr.close()
            pub2 = pkg.WeightPublisher(str(d))
            mgr2 = pkg.checkpoint.CheckpointManager(
                str(d), rank=0, world_size=1, async_save=False,
                on_commit=pub2.publish)
            mgr2.save(tree, 3, block=True)
            mgr2.close()
            _s, _d, m = pkg.checkpoint.latest_manifest(str(d))
            return pub.next_generation, m["generation"]
        assert _same(_both(tmp_path, scenario)) == (3, 3)

    def test_publish_event_and_metrics(self, tmp_path):
        def scenario(pkg, d):
            mgr, _ = pkg.manager(d)
            mgr.save({"w": np.ones(2, np.float32)}, 1, block=True)
            mgr.close()
            snap = pkg.metrics.get_registry().snapshot()
            return (_events(snap, "fleet_publish",
                            ("generation", "step", "dir", "files")),
                    _value(snap, "hvd_fleet_publishes_total"),
                    _value(snap, "hvd_fleet_published_generation"))
        events, pubs, gen = _same(_both(tmp_path, scenario))
        assert events == [{"generation": 1, "step": 1,
                           "dir": "step-0000000001", "files": 2}]
        assert (pubs, gen) == (1, 1)


class TestCheckpointerPublish:
    @pytest.mark.parametrize("how", ["argument", "env", "rank1", "off"])
    def test_checkpointer_publishes_on_rank0(self, tmp_path, monkeypatch,
                                             how):
        """``trainer.Checkpointer(publish=)`` (or HVD_FLEET_PUBLISH=1)
        hangs the publisher on rank 0's commit hook: each committed
        step_end save is a generation; other ranks and the default
        publish nothing."""
        def scenario(pkg, d):
            if pkg.name == "jax":
                from horovod_tpu import trainer
            else:
                from horovod_tpu_torch import trainer
            kw = {"every": 1, "preemption": False, "async_save": False}
            if how == "env":
                monkeypatch.setenv("HVD_FLEET_PUBLISH", "1")
            elif how != "off":
                kw["publish"] = True
            if how == "rank1":
                mgr = pkg.checkpoint.CheckpointManager(
                    str(d), rank=1, world_size=2, async_save=False)
                kw["manager"] = mgr
            ckpt = trainer.Checkpointer(str(d), **kw)
            monkeypatch.delenv("HVD_FLEET_PUBLISH", raising=False)
            published = ckpt.publisher is not None
            if how != "rank1":
                for step in (1, 2):
                    ckpt.step_end(step, {"w": np.full(3, step, np.float32)})
            ckpt.close()
            pointer = pkg.checkpoint.manifest_signature(str(d)) is not None
            latest = pkg.checkpoint.latest_manifest(str(d))
            return (published, pointer,
                    None if latest is None else
                    (latest[0], latest[2].get("generation")))
        rec = _same(_both(tmp_path, scenario))
        assert rec == {"argument": (True, True, (2, 2)),
                       "env": (True, True, (2, 2)),
                       "rank1": (False, False, None),
                       "off": (False, False, (2, None))}[how]


class TestCrossPackagePointer:
    @pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                               ("torch", "jax")])
    def test_pointer_read_by_the_other_package(self, tmp_path, writer,
                                               reader):
        w, r = Pkg(writer), Pkg(reader)
        tree = {"b": np.arange(3, dtype=np.float32),
                "w": np.linspace(-1, 1, 8, dtype=np.float32)}
        mgr, _ = w.manager(tmp_path)
        mgr.save(tree, 4, block=True)
        mgr.save({k: v * 2 for k, v in tree.items()}, 9, block=True)
        mgr.close()
        want = w.checkpoint.latest_manifest(str(tmp_path))
        got = r.checkpoint.latest_manifest(str(tmp_path))
        assert got == want and got[0] == 9 and got[2]["generation"] == 2
        assert r.checkpoint.manifest_signature(str(tmp_path)) == \
            w.checkpoint.manifest_signature(str(tmp_path))
        sub = r.subscriber(tmp_path, like=tree)
        init = sub.load_initial()
        assert (init.generation, init.step) == (2, 9)
        for k, v in tree.items():
            np.testing.assert_array_equal(_arr(init.params[k]), v * 2)
        # the other package publishes the next generation into the same
        # directory: its publisher continues the writer's count
        pub = r.WeightPublisher(str(tmp_path))
        assert pub.next_generation == 3

    def test_pointer_json_is_byte_equal(self, tmp_path):
        j, t = Pkg("jax"), Pkg("torch")
        mgr, _ = j.manager(tmp_path / "src", publish=False)
        mgr.save({"w": np.ones(5, np.float32)}, 6, block=True)
        mgr.close()
        step, sd, manifest = j.checkpoint.latest_manifest(
            str(tmp_path / "src"))
        raw = {}
        for pkg in (j, t):
            d = tmp_path / pkg.name
            d.mkdir()
            pkg.metrics.reset(enabled=True)
            gen = pkg.WeightPublisher(str(d)).publish(step, sd, manifest)
            pkg.metrics.reset()
            raw[pkg.name] = (gen, (d / "manifest.json").read_bytes())
        assert raw["torch"] == raw["jax"]
        d = tmp_path / "direct"
        for pkg in (j, t):
            d.mkdir(exist_ok=True)
            pkg.checkpoint.write_pointer(str(d), dict(manifest, x=[1, 2]))
            raw[pkg.name] = (d / "manifest.json").read_bytes()
        assert raw["torch"] == raw["jax"]


# ---------------------------------------------------------------------------
# the subscriber state machine (numpy trees, no device transfer)
# ---------------------------------------------------------------------------

class TestWeightSubscriber:
    def test_load_initial_then_poll_arms_new_generation(self, tmp_path):
        def scenario(pkg, d):
            like = {"w": np.zeros(4, np.float32)}
            mgr, _ = pkg.manager(d)
            mgr.save({"w": np.full(4, 1.0, np.float32)}, 1, block=True)
            sub = pkg.subscriber(d, like)
            init = sub.load_initial()
            rec = [init.generation, sub.current_generation,
                   _arr(init.params["w"]).tolist(), sub.poll()]
            mgr.save({"w": np.full(4, 2.0, np.float32)}, 2, block=True)
            mgr.close()
            rec += [sub.poll(), sub.wait(30)]
            got = sub.take_armed()
            rec += [got.generation, _arr(got.params["w"]).tolist(),
                    sub.current_generation,
                    got.detect_ts <= got.loaded_ts <= got.armed_ts]
            return rec
        assert _same(_both(tmp_path, scenario)) == [
            1, 1, [1.0] * 4, False, True, True, 2, [2.0] * 4, 2, True]

    def test_corrupt_generation_refused(self, tmp_path):
        def scenario(pkg, d):
            like = {"w": np.zeros(4, np.float32)}
            mgr, _ = pkg.manager(d)
            mgr.save({"w": np.ones(4, np.float32)}, 1, block=True)
            sub = pkg.subscriber(d, like)
            sub.load_initial()
            mgr.save({"w": np.full(4, 2.0, np.float32)}, 2, block=True)
            with open(os.path.join(str(d), "step-0000000002",
                                   "rank00000.npz"), "r+b") as f:
                f.write(b"\xff\xff\xff\xff")
            rec = [sub.poll(), sub.wait(30), sub.take_armed(),
                   sub.current_generation, sub.refusals]
            snap = pkg.metrics.get_registry().snapshot()
            rec += [_events(snap, "fleet_refuse",
                            ("generation", "reason", "replica")),
                    _value(snap, "hvd_fleet_refusals_total",
                           reason="corrupt"),
                    sub.poll(force=True)]
            mgr.save({"w": np.full(4, 3.0, np.float32)}, 3, block=True)
            mgr.close()
            rec += [sub.poll(force=True), sub.wait(30),
                    sub.take_armed().generation]
            return rec
        assert _same(_both(tmp_path, scenario)) == [
            True, True, None, 1, {2: "corrupt"},
            [{"generation": 2, "reason": "corrupt", "replica": 0}], 1,
            False, True, True, 3]

    def test_mismatched_tree_refused(self, tmp_path):
        def scenario(pkg, d):
            like = {"w": np.zeros(4, np.float32)}
            mgr, _ = pkg.manager(d)
            mgr.save({"w": np.ones(4, np.float32)}, 1, block=True)
            sub = pkg.subscriber(d, like)
            sub.load_initial()
            mgr.save({"w": np.ones(4, np.float32),
                      "extra_head": np.ones(2, np.float32)}, 2, block=True)
            mgr.close()
            return [sub.poll(), sub.wait(30), sub.take_armed(),
                    sub.refusals]
        assert _same(_both(tmp_path, scenario)) == [True, True, None,
                                                    {2: "mismatch"}]

    def test_latest_wins_double_buffer(self, tmp_path):
        def scenario(pkg, d):
            like = {"w": np.zeros(2, np.float32)}
            mgr, _ = pkg.manager(d)
            mgr.save({"w": np.full(2, 1.0, np.float32)}, 1, block=True)
            sub = pkg.subscriber(d, like)
            sub.load_initial()
            mgr.save({"w": np.full(2, 2.0, np.float32)}, 2, block=True)
            rec = [sub.poll(), sub.wait(30), sub.armed_generation]
            mgr.save({"w": np.full(2, 3.0, np.float32)}, 3, block=True)
            mgr.close()
            rec += [sub.poll(force=True), sub.wait(30),
                    sub.take_armed().generation, sub.take_armed()]
            return rec
        assert _same(_both(tmp_path, scenario)) == [True, True, 2, True,
                                                    True, 3, None]

    def test_loader_crash_is_refused_and_reraised(self, tmp_path,
                                                  monkeypatch):
        """A loader failure other than a bad checkpoint (on the card, a
        failed transfer) is refused as ``error`` and re-raised on the
        engine thread's next poll, in both packages."""
        def scenario(pkg, d):
            like = {"w": np.zeros(2, np.float32)}
            mgr, _ = pkg.manager(d)
            mgr.save({"w": np.ones(2, np.float32)}, 1, block=True)
            sub = pkg.subscriber(d, like)
            sub.load_initial()
            mgr.save({"w": np.full(2, 2.0, np.float32)}, 2, block=True)
            mgr.close()

            def boom(*a, **k):
                raise RuntimeError("transfer failed")
            monkeypatch.setattr(pkg.checkpoint, "restore_with_extra",
                                boom)
            try:
                started = sub.poll()
                with pytest.raises(pkg.exceptions.CheckpointError,
                                   match="transfer failed"):
                    sub.wait(30)
            finally:
                monkeypatch.undo()
            return [started, sub.refusals, sub.take_armed(),
                    sub.current_generation]
        assert _same(_both(tmp_path, scenario)) == [True, {2: "error"},
                                                    None, 1]


def test_device_transfer_is_a_noop_on_the_cpu(tmp_path):
    """The port's subscriber with its default ``device_put`` and a CPU
    template: the loaded tree stays on the CPU, no event is recorded."""
    t = Pkg("torch")
    like = {"w": torch.zeros(3, dtype=torch.bfloat16)}
    mgr, _ = t.manager(tmp_path)
    mgr.save({"w": torch.arange(3, dtype=torch.bfloat16)}, 1, block=True)
    mgr.close()
    sub = t.WeightSubscriber(str(tmp_path), like=like)
    assert sub.device_put and sub.device == torch.device("cpu")
    init = sub.load_initial()
    assert init.event is None
    assert init.params["w"].dtype == torch.bfloat16
    assert init.params["w"].device.type == "cpu"
    assert init.params["w"].tolist() == [0.0, 1.0, 2.0]


# ---------------------------------------------------------------------------
# the engine hot swap on the tiny LM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flax_trees():
    from horovod_tpu.models import transformer as jtr
    cfg = jtr.TransformerConfig.tiny(dtype=jnp.float32,
                                     attention_impl="full")
    _, params0 = jtr.init_params(cfg, jax.random.PRNGKey(0))
    params1 = jax.tree_util.tree_map(lambda a: a * 1.5, params0)
    return cfg, params0, params1


def _port_cfg():
    return ttr.TransformerConfig.tiny(dtype=torch.float32,
                                      attention_impl="full")


def _port_tree(tree):
    return serving_tree(params_from_flax(jax.device_get(tree), _port_cfg(),
                                         device="cpu"))


def _jax_engine(cfg, params, **kw):
    from horovod_tpu.serving.engine import ServeEngine
    from horovod_tpu.serving.queue import AdmissionQueue
    return ServeEngine(cfg, params, num_slots=2, max_len=48, kv_block=8,
                       queue=AdmissionQueue(max_depth=64,
                                            admission_timeout_s=1e9), **kw)


def _port_engine(params, mesh=None, **kw):
    """The port's engine over a ``TransformerLM``, or over weights by name
    built into one (the JAX engine takes the tree itself)."""
    from horovod_tpu_torch.serving.engine import ServeEngine
    if isinstance(params, dict):
        params = model_from_tree(_port_cfg(), params, "cpu")
    from horovod_tpu_torch.serving.queue import AdmissionQueue
    return ServeEngine(_port_cfg(), params, num_slots=2, max_len=48,
                       kv_block=8, device="cpu", mesh=mesh,
                       queue=AdmissionQueue(max_depth=64,
                                            admission_timeout_s=1e9), **kw)


def _mid_stream_swap(pkg, d, make_engine, tree0, tree1, publish=True,
                     sync=None):
    """The swap script of tests/test_fleet.py: generation 1 serves, an
    ``old-gen`` request is mid-stream when generation 2 is published, a
    ``new-gen`` request is admitted after the swap. ``publish`` (False on
    all but one thread rank) says whether this caller saves; ``sync`` is
    a barrier the thread ranks meet at around the publish. Returns the
    results by id and the engine."""
    mgr = None
    if publish:
        mgr, _ = pkg.manager(d)
        mgr.save(tree0, 1, block=True)
    if sync is not None:
        sync.wait()
    sub = pkg.subscriber(d, tree0)
    init = sub.load_initial()
    eng = make_engine(init.params, subscriber=sub,
                      generation=init.generation)
    eng.submit(pkg.queue.Request("old-gen", PROMPT, max_new_tokens=N_OLD,
                                 temperature=0.0))
    results = {}
    for _ in range(6):
        for r in eng.step():
            results[r.request_id] = r
    assert eng.active_count == 1
    if publish:
        mgr.save(tree1, 2, block=True)
        mgr.close()
    if sync is not None:
        sync.wait()
    assert sub.poll(force=True) and sub.wait(30)
    eng.submit(pkg.queue.Request("new-gen", PROMPT, max_new_tokens=N_NEW,
                                 temperature=0.0))
    for _ in range(300):
        for r in eng.step():
            results[r.request_id] = r
        if len(results) == 2:
            break
    return results, eng


def _swap_record(pkg, results, eng):
    snap = pkg.metrics.get_registry().snapshot()
    swaps = _events(snap, "fleet_swap", ("generation", "from_generation",
                                         "step", "inflight", "replica"))
    by_id = {k: (list(r.tokens), r.generation, r.outcome)
             for k, r in results.items()}
    admits = {e["request_id"]: e["generation"]
              for e in snap["events"] if e["event"] == "serve_admit"}
    retires = {e["request_id"]: e["generation"]
               for e in snap["events"] if e["event"] == "serve_retire"}
    return {"results": by_id, "swaps": swaps, "admits": admits,
            "retires": retires, "engine_generation": eng.generation,
            "params_by_gen": sorted(eng._params_by_gen),
            "swaps_total": _value(snap, "hvd_fleet_swaps_total"),
            "generation_gauge": _value(snap, "hvd_fleet_generation",
                                       replica="0"),
            "last_swap_keys": sorted(eng.last_swap)}


class TestEngineHotSwap:
    def test_mid_stream_swap_equals_jax_engine(self, tmp_path, flax_trees):
        """The tentpole invariant in both packages: the in-flight request
        crosses the swap token for token on its admit-time weights, the
        post-swap request runs on the new ones, and the tokens, the
        generations on results, events and the engine are the JAX
        engine's."""
        jcfg, params0, params1 = flax_trees
        trees = {"jax": (params0, params1),
                 "torch": (_port_tree(params0), _port_tree(params1))}

        def scenario(pkg, d):
            pkg.tracing.reset(enabled=True, rank=0)
            try:
                if pkg.name == "jax":
                    def make(p, **kw):
                        return _jax_engine(jcfg, p, **kw)
                else:
                    make = _port_engine
                results, eng = _mid_stream_swap(pkg, d, make,
                                                *trees[pkg.name])
                return _swap_record(pkg, results, eng)
            finally:
                pkg.tracing.reset()
        rec = _same(_both(tmp_path, scenario))
        assert rec["results"]["old-gen"][1:] == (1, "completed")
        assert rec["results"]["new-gen"][1:] == (2, "completed")
        assert rec["swaps"] == [{"generation": 2, "from_generation": 1,
                                 "step": 2, "inflight": 1, "replica": 0}]
        assert rec["admits"] == {"old-gen": 1, "new-gen": 2}
        assert rec["retires"] == {"old-gen": 1, "new-gen": 2}
        assert rec["engine_generation"] == 2
        assert rec["params_by_gen"] == [2]
        assert (rec["swaps_total"], rec["generation_gauge"]) == (1, 2)
        # the oracle: each side of the boundary against a fresh engine
        # on its own weights
        t0, t1 = trees["torch"]
        for rid, tree, n in (("old-gen", t0, N_OLD), ("new-gen", t1, N_NEW)):
            from horovod_tpu_torch.serving.queue import Request
            eng = _port_engine(tree)
            eng.submit(Request("ref", PROMPT, max_new_tokens=n))
            (solo,) = eng.run_to_completion()
            assert rec["results"][rid][0] == list(solo.tokens)

    def test_swap_on_a_tp2_engine_equals_the_unsharded_swap(self, tmp_path,
                                                            flax_trees):
        """The same swap on a tp-2 engine of two thread ranks (each with
        its own subscriber on the shared directory, the swap agreed over
        the tp group): every rank's tokens and generations are the
        unsharded engine's."""
        _, params0, params1 = flax_trees
        tree0, tree1 = _port_tree(params0), _port_tree(params1)
        t = Pkg("torch")
        t.metrics.reset(enabled=True)
        try:
            (tmp_path / "one").mkdir()
            one, _ = _mid_stream_swap(t, tmp_path / "one", _port_engine,
                                      tree0, tree1)
            want = {k: (list(r.tokens), r.generation)
                    for k, r in one.items()}
            views = tmesh.thread_meshes(tmesh.build_mesh(
                tp=2, devices=[0, 1]))
            (tmp_path / "tp").mkdir()
            sync = threading.Barrier(2)
            out, errors = [None, None], []

            def rank(r):
                try:
                    with tmesh.use_mesh(views[r]):
                        res, eng = _mid_stream_swap(
                            t, tmp_path / "tp",
                            lambda p, **kw: _port_engine(p, views[r], **kw),
                            tree0, tree1, publish=(r == 0), sync=sync)
                        out[r] = ({k: (list(x.tokens), x.generation)
                                   for k, x in res.items()},
                                  eng.generation, sorted(eng._params_by_gen))
                except Exception as exc:  # noqa: BLE001 — asserted below
                    errors.append(exc)
                    sync.abort()
                    for v in views:
                        for c in list(v._comms.values()) + [v._world]:
                            c.world._barrier.abort()
            threads = [threading.Thread(target=rank, args=(r,))
                       for r in range(2)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            assert not errors, errors
            assert not any(th.is_alive() for th in threads)
            for r in range(2):
                assert out[r] == (want, 2, [2])
        finally:
            t.metrics.reset()

    def test_generation_annotated_on_request_trace(self):
        from horovod_tpu_torch.serving.queue import Request
        from horovod_tpu_torch.utils import tracing
        tracing.reset(enabled=True, rank=0)
        try:
            cfg = _port_cfg()
            model = ttr.init_params(cfg, device="cpu")
            eng = _port_engine(model, generation=7)
            req = Request("traced", (1, 2, 3), max_new_tokens=3)
            eng.submit(req)
            (res,) = eng.run_to_completion()
            assert res.generation == 7
            assert req.trace.root.attrs["generation"] == 7
            assert eng.load_snapshot()["generation"] == 7
            assert eng.load_snapshot()["armed_generation"] is None
        finally:
            tracing.reset()

    def test_engine_without_subscriber_defaults_generation_zero(self):
        from horovod_tpu_torch.serving.queue import Request
        model = ttr.init_params(_port_cfg(), device="cpu")
        eng = _port_engine(model)
        eng.submit(Request("plain", (1, 2, 3), max_new_tokens=2))
        (res,) = eng.run_to_completion()
        assert res.generation == 0

    def test_corrupt_publish_keeps_serving_old_generation(self, tmp_path,
                                                          flax_trees):
        _, params0, params1 = flax_trees
        tree0, tree1 = _port_tree(params0), _port_tree(params1)
        t = Pkg("torch")
        reg = t.metrics.reset(enabled=True)
        try:
            mgr, _ = t.manager(tmp_path)
            mgr.save(tree0, 1, block=True)
            sub = t.subscriber(tmp_path, tree0)
            init = sub.load_initial()
            eng = _port_engine(init.params, subscriber=sub,
                               generation=init.generation)
            mgr.save(tree1, 2, block=True)
            mgr.close()
            with open(os.path.join(str(tmp_path), "step-0000000002",
                                   "rank00000.npz"), "r+b") as f:
                f.write(b"\xff\xff\xff\xff")
            eng.submit(t.queue.Request("survivor", PROMPT[:4],
                                       max_new_tokens=6))
            assert sub.poll(force=True) and sub.wait(30)
            (res,) = eng.run_to_completion()
            assert eng.generation == 1 and res.generation == 1
            assert res.outcome == "completed"
            solo = _port_engine(tree0)
            solo.submit(t.queue.Request("ref", PROMPT[:4],
                                        max_new_tokens=6))
            assert res.tokens == solo.run_to_completion()[0].tokens
            snap = reg.snapshot()
            assert _events(snap, "fleet_refuse", ("reason",)) == [
                {"reason": "corrupt"}]
            assert not _events(snap, "fleet_swap", ())
        finally:
            t.metrics.reset()

    def test_swap_gate_holds_the_armed_generation(self, tmp_path,
                                                  flax_trees):
        """A closed swap gate (the canary's holdback) keeps the engine on
        its weights with the generation still armed and offered again;
        opening it swaps at the next step."""
        _, params0, params1 = flax_trees
        tree0, tree1 = _port_tree(params0), _port_tree(params1)
        t = Pkg("torch")
        t.metrics.reset(enabled=True)
        try:
            mgr, _ = t.manager(tmp_path)
            mgr.save(tree0, 1, block=True)
            sub = t.subscriber(tmp_path, tree0)
            init = sub.load_initial()
            gate = {"open": False, "asked": []}

            def swap_gate(gen):
                gate["asked"].append(gen)
                return gate["open"]
            eng = _port_engine(init.params, subscriber=sub,
                               generation=init.generation,
                               swap_gate=swap_gate)
            mgr.save(tree1, 2, block=True)
            mgr.close()
            assert sub.poll(force=True) and sub.wait(30)
            eng.step()
            eng.step()
            assert eng.generation == 1 and gate["asked"] == [2, 2]
            assert eng.load_snapshot()["armed_generation"] == 2
            gate["open"] = True
            eng.step()
            assert eng.generation == 2
            assert eng.load_snapshot()["armed_generation"] is None
            assert eng.last_swap["from_generation"] == 1
        finally:
            t.metrics.reset()
