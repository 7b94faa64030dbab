"""The eager core with the observability planes on: two gloo CPU ranks
(the port's ``run()``, negotiated by the job's secret) take three steps
of the tiny two-layer LM through ``trainer.build_eager_lm_step`` with
metrics and tracing on, then the same three steps with both planes off
(``HVD_METRICS=0``, ``HVD_TRACE=0``).

What is held, and how:

  * equality: the fusion tensor and byte totals of rank 0's coordinator
    equal the JAX package's coordinator fed the same gradient names and
    sizes (announced by two ranks, three steps), and so do the wire bytes
    (``hvd_wire_bytes_total``) each rank accounts, against the JAX
    package's ``quantization.account`` over the JAX coordinator's plan;
  * invariant: every gradient of the last step has one closed span tree
    enqueue -> negotiate -> fusion -> execute -> callback, in that order
    and parent chain, under one trace id, and its negotiate span's
    ``cycle`` is the same on both ranks (which cycle orders it depends on
    timing);
  * equality: with both planes off, every parameter is bit-equal to the
    run with them on, on both ranks.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.run.launch import run

RUN_TIMEOUT_S = 120.0
STEPS = 3
STAGES = ("enqueue", "negotiate", "fusion", "execute", "callback")


def _job():
    def fn():
        import os
        import torch
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import trainer
        from horovod_tpu_torch.models import transformer as tr
        from horovod_tpu_torch.utils import metrics, tracing
        hvd.init(device="cpu")
        cfg = tr.TransformerConfig.tiny(dtype=torch.float32,
                                        attention_impl="full")
        step, model, _, toks = trainer.build_eager_lm_step(
            cfg, 2, 16, torch.device("cpu"), inner=3)
        for i in range(3):
            step(toks[i])
        reg = metrics.get_registry()
        out = {"rank": hvd.rank(),
               "on": reg.enabled and tracing.get_tracer().enabled,
               "params": [p.detach().clone().numpy()
                          for p in model.parameters()],
               "grads": [(f"hvd.eager_grads.{i}", str(p.dtype).split(".")[1],
                          tuple(p.shape))
                         for i, p in enumerate(
                             p for p in model.parameters()
                             if p.requires_grad)],
               "snapshot": reg.snapshot(),
               "spans": tracing.get_tracer().spans(),
               "open": [s.to_dict() for s in
                        tracing.get_tracer().open_spans()],
               "env": (os.environ.get("HVD_METRICS"),
                       os.environ.get("HVD_TRACE"))}
        hvd.shutdown()
        return out
    return fn


@pytest.fixture(scope="module")
def runs():
    on = run(_job(), num_proc=2, env={"HVD_FLIGHT_SIGTERM": "0"},
             start_timeout_s=RUN_TIMEOUT_S)
    off = run(_job(), num_proc=2,
              env={"HVD_METRICS": "0", "HVD_TRACE": "0"},
              start_timeout_s=RUN_TIMEOUT_S)
    return {"on": on, "off": off}


def _value(snap, name, **labels):
    fam = snap["metrics"].get(name)
    if fam is None:
        return 0.0
    return sum(v["value"] for v in fam["values"]
               if all(v["labels"].get(k) == lv for k, lv in labels.items()))


def _jax_reference(grads):
    """The JAX package's coordinator fed the same announcements (two
    ranks, three steps), and its wire accounting over the plan."""
    from horovod_tpu.common.config import HorovodConfig
    from horovod_tpu.ops import negotiation as jneg
    from horovod_tpu.ops import quantization as jq
    from horovod_tpu.ops.fusion import _nbytes
    from horovod_tpu.utils import metrics as jm
    reg = jm.reset(enabled=True)
    svc = jneg.CoordinatorService(2, b"k" * 32, ports=[0],
                                  config=HorovodConfig())
    try:
        ack = -1
        for step in range(STEPS):
            metas = [jneg.EntryMeta(n, "allreduce", d, s, 0, True)
                     for n, d, s in grads]
            for r in (0, 1):
                resp = svc._handle(jneg.CycleRequest(
                    r, metas, ack, req_id=step + 1), ("127.0.0.1", 0))
            by_name = {m.name: m for m in metas}
            for r in resp.responses[max(0, ack + 1 - resp.base_seq):]:
                assert r.kind == r.EXECUTE
                nb = sum(_nbytes(by_name[n]) for n in r.names)
                jq.account(r.codec, nb, nb)
            ack = resp.base_seq + len(resp.responses) - 1
        return reg.snapshot()
    finally:
        svc.shutdown()
        jm.reset()


class TestInstrumentedEagerCore:
    def test_planes_on_and_off(self, runs):
        assert [r["on"] for r in runs["on"]] == [True, True]
        assert [r["on"] for r in runs["off"]] == [False, False]
        assert runs["off"][0]["snapshot"].get("disabled")

    def test_fusion_and_wire_bytes_equal_the_jax_core(self, runs):
        r0, r1 = runs["on"]
        assert r0["grads"] == r1["grads"]
        ref = _jax_reference(r0["grads"])
        port = r0["snapshot"]
        total = STEPS * sum(int(np.prod(s)) * 4 for _, _, s in r0["grads"])
        for name in ("hvd_fusion_tensors_total", "hvd_fusion_bytes_total"):
            assert _value(port, name) == _value(ref, name), name
        assert _value(port, "hvd_fusion_tensors_total") == \
            STEPS * len(r0["grads"])
        assert _value(port, "hvd_fusion_bytes_total") == total
        for res in runs["on"]:
            for name in ("hvd_wire_bytes_total", "hvd_wire_raw_bytes_total"):
                assert _value(res["snapshot"], name, codec="none",
                              axis="dp") == \
                    _value(ref, name, codec="none", axis="dp") == total
            # every gradient went through the data plane
            assert _value(res["snapshot"], "hvd_collective_bytes_total",
                          op="allreduce") == total
            assert _value(res["snapshot"],
                          "hvd_negotiation_cycles_total") >= STEPS

    def test_every_gradient_has_one_closed_tree(self, runs):
        cycles = []
        for res in runs["on"]:
            assert not [s for s in res["open"]
                        if s.get("tensor", "").startswith("hvd.eager_grads")]
            by_name = {}
            for s in res["spans"]:
                if s.get("tensor", "").startswith("hvd.eager_grads") and \
                        s["stage"] in STAGES:
                    by_name.setdefault(s["tensor"], []).append(s)
            mine = {}
            for name, _, _ in res["grads"]:
                spans = by_name[name]
                last = spans[-1]["trace_id"]  # the newest step's trace
                tree = sorted((s for s in spans if s["trace_id"] == last),
                              key=lambda s: (s["start_us"], s["span_id"]))
                assert [s["stage"] for s in tree] == list(STAGES), \
                    (name, tree)
                assert all(s["status"] == "ok" for s in tree), tree
                assert all(s["end_us"] >= s["start_us"] for s in tree)
                for parent, child in zip(tree, tree[1:]):
                    assert child["parent_id"] == parent["span_id"], tree
                neg = tree[1]["attrs"]
                assert neg["cache_hit"] is True  # a steady-state step
                mine[name] = neg["cycle"]
                assert tree[3]["attrs"]["fused"] >= 1
            cycles.append(mine)
        assert cycles[0] == cycles[1]

    def test_planes_off_is_bit_equal(self, runs):
        for on, off in zip(runs["on"], runs["off"]):
            assert on["rank"] == off["rank"]
            assert len(on["params"]) == len(off["params"])
            for a, b in zip(on["params"], off["params"]):
                assert torch.equal(torch.from_numpy(a), torch.from_numpy(b))
            assert off["spans"] == [] and off["open"] == []
