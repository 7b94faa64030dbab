"""horovod_tpu_torch.route_lm against examples/route_lm.py.

``python -m horovod_tpu_torch.route_lm --device cpu --compare`` runs the
tiny config behind two replicas under least_loaded and round_robin: both
arms complete every request and print one JSON line. Then each arm's
``route_workload``, on the JAX package's tiny fp32 checkpoint
(``params_from_flax``) and the same seeded workload, against
``examples/route_lm.route_workload`` loaded by path: the replica that
served each request and its temperature-0 tokens are the same.
"""

import importlib.util
import json
import os

import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu_torch import route_lm, serve_lm
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPLICAS, SLOTS, MAX_LEN, KV_BLOCK, REQUESTS, RATE = 2, 2, 64, 8, 16, 0.5


def _reference(monkeypatch):
    """examples/route_lm.py and examples/serve_lm.py as modules."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "examples"))
    spec = importlib.util.spec_from_file_location(
        "reference_route_lm", os.path.join(ROOT, "examples", "route_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, importlib.import_module("serve_lm")


def test_compare_on_the_cpu_completes_both_arms(capsys):
    assert route_lm.main(["--device", "cpu", "--compare",
                          "--requests", str(REQUESTS)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["max_len"] == 64
    for arm in ("least_loaded", "round_robin"):
        got = out[arm]
        assert (got["completed"], got["failed"]) == (REQUESTS, 0)
        assert sum(got["by_replica"].values()) == REQUESTS
        assert set(got["by_replica"]) == {"0", "1"}
        assert got["ttft_p99_s"] >= got["ttft_p50_s"] > 0
        assert got["intertoken_p99_s"] >= got["intertoken_p50_s"] > 0
        assert got["kernel_launches"] == {}
    assert out["p99_ttft_ratio"] > 0


@pytest.mark.parametrize("policy", ["least_loaded", "round_robin"])
def test_route_workload_equals_the_reference(policy, monkeypatch):
    ref, ref_serve = _reference(monkeypatch)
    from horovod_tpu.models import transformer as jtr
    jcfg = ref_serve.serving_config(False)
    _, params = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32,
                                     attention_impl="full")
    model = params_from_flax(jax.device_get(params), cfg, device="cpu")

    jax_results = []
    run_routed = ref.run_routed

    def capture(router, workload, max_steps=100000):
        out = run_routed(router, workload, max_steps)
        jax_results.extend(out[0])
        return out
    monkeypatch.setattr(ref, "run_routed", capture)
    want = ref.route_workload(
        jcfg, params, ref_serve.make_workload(0, REQUESTS, RATE), policy,
        REPLICAS, SLOTS, MAX_LEN, kv_block=KV_BLOCK, seed=0)

    workload = serve_lm.make_workload(0, REQUESTS, RATE)
    assert [(t, r.request_id, r.prompt, r.max_new_tokens)
            for t, r in workload] == [
        (t, r.request_id, r.prompt, r.max_new_tokens)
        for t, r in ref_serve.make_workload(0, REQUESTS, RATE)]
    results = []
    got = route_lm.route_workload(cfg, model, workload, policy, REPLICAS,
                                  SLOTS, MAX_LEN, kv_block=KV_BLOCK, seed=0,
                                  device="cpu", results=results)
    assert (got["completed"], got["failed"]) == (REQUESTS, 0)
    for key in ("completed", "failed", "by_replica", "decode_tokens",
                "steps"):
        assert got[key] == want[key], key
    assert {r.request_id: (r.replica, r.rerouted, list(r.tokens))
            for r in results} == {
        r.request_id: (r.replica, r.rerouted, list(r.tokens))
        for r in jax_results}
    # the arm submitted copies: the caller's requests are untouched
    assert all(r.arrival_ts == 0.0 and r.trace is None
               for _, r in workload)
