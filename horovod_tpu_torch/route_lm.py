"""Serve the transformer LM behind the router plane, on the port.

Fronts N serving replicas with one ``Router`` and drives the same bimodal
open-loop workload ``serve_lm`` uses, through the front door: every
request is dispatched by the routing policy over live load snapshots,
with cache-affinity stickiness on prompt prefixes. With ``--compare`` the
SAME workload also runs under round_robin on fresh replicas, so the
load-aware policy's tail latency is measured against the load-blind one.
Prints one JSON result line. The counterpart of ``examples/route_lm.py``.

Usage:
    # the card: GPT-2-small (6 x 128 heads), bf16, flash kernels in every
    # replica's prefill; 2 replicas, least_loaded vs round_robin
    python -m horovod_tpu_torch.route_lm --compare

    # CPU, tiny fp32 config
    python -m horovod_tpu_torch.route_lm --device cpu --compare
"""

import argparse
import dataclasses
import json
import sys
import time

import torch

from .models import transformer as tr
from .ops import flash_attention as fa
from .router import Router
from .router.canary import intertoken_gap
from .serve_lm import make_workload, serving_config, serving_defaults
from .serving.engine import ServeEngine
from .serving.queue import AdmissionQueue
from .utils import metrics as hvd_metrics


def run_routed(router, workload, max_steps=100000):
    """Drive the router under the arrival schedule: submit every request
    whose arrival step has passed, then step every replica. Returns
    (results, steps, wall_s)."""
    i = 0
    steps = 0
    results = []
    t0 = time.monotonic()
    while i < len(workload) or router.pending():
        while i < len(workload) and workload[i][0] <= steps:
            router.submit(workload[i][1])
            i += 1
        results.extend(router.step())
        steps += 1
        if steps >= max_steps:
            raise RuntimeError(
                f"load never drained in {max_steps} steps "
                f"({len(results)} done)")
    return results, steps, time.monotonic() - t0


def _pct(values, q):
    values = sorted(values)
    if not values:
        return None
    return values[min(len(values) - 1, int(q * len(values)))]


def summarize(policy, engines, results, steps, wall_s):
    """One arm's JSON summary: completions, the split between replicas,
    throughput, TTFT and per-request mean inter-token gaps at p50/p99.
    Raises when a replica leaked KV blocks."""
    completed = [r for r in results if r.outcome == "completed"]
    decode_tokens = sum(len(r.tokens) for r in completed)
    by_replica = {}
    for r in completed:
        by_replica[r.replica] = by_replica.get(r.replica, 0) + 1
    for rid, eng in engines.items():
        if eng.kv.ledger.blocks_in_use:
            raise RuntimeError(f"{eng.kv.ledger.blocks_in_use} KV blocks "
                               f"leaked on replica {rid}")
    ttfts = [r.ttft_s for r in completed if r.ttft_s is not None]
    gaps = [g for g in (intertoken_gap(r) for r in completed)
            if g is not None]
    return {
        "policy": policy,
        "replicas": len(engines),
        "completed": len(completed),
        "failed": len(results) - len(completed),
        "by_replica": {str(k): v for k, v in sorted(by_replica.items())},
        "decode_tokens": decode_tokens,
        "steps": steps,
        "tokens_per_step": decode_tokens / max(steps, 1),
        "wall_s": wall_s,
        "tokens_per_s": decode_tokens / wall_s if wall_s else 0.0,
        "ttft_p50_s": _pct(ttfts, 0.50),
        "ttft_p99_s": _pct(ttfts, 0.99),
        "intertoken_p50_s": _pct(gaps, 0.50),
        "intertoken_p99_s": _pct(gaps, 0.99),
    }


def route_workload(cfg, model, workload, policy, replicas, num_slots,
                   max_len, kv_block=8, seed=0, device=None, results=None):
    """One arm of the comparison: ``replicas`` fresh engines behind a
    fresh Router under ``policy``; the arms share nothing but the
    weights. Each engine's admission queue holds the whole workload and
    never times a request out, so an arm completes every request however
    slow its steps are. ``results`` (a list) receives the arm's
    RequestResults, stamped with their replica. The arm submits fresh
    copies of ``workload``'s requests: a request's arrival time and trace
    are stamped at its submission, and must not carry over between
    arms."""
    workload = [(t, dataclasses.replace(req, arrival_ts=0.0, trace=None))
                for t, req in workload]
    engines = {
        rid: ServeEngine(cfg, model, num_slots=num_slots, max_len=max_len,
                         kv_block=kv_block, seed=seed, device=device,
                         queue=AdmissionQueue(max_depth=len(workload) + 1,
                                              admission_timeout_s=1e9))
        for rid in range(replicas)}
    router = Router(engines, policy=policy)
    got, steps, wall_s = run_routed(router, workload)
    if results is not None:
        results.extend(got)
    return summarize(policy, engines, got, steps, wall_s)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--slots", type=int, default=2,
                    help="decode slots per replica")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=0.5,
                    help="mean arrivals per decode step (open loop)")
    ap.add_argument("--max-len", type=int, default=None,
                    help="cache rows per slot (default 1024 on cuda, "
                         "64 on cpu)")
    ap.add_argument("--kv-block", type=int, default=None,
                    help="KV block rows (default 16 on cuda, 8 on cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", default="least_loaded",
                    help="dispatch policy (HVD_ROUTE_POLICY)")
    ap.add_argument("--compare", action="store_true",
                    help="also run the round_robin arm and report the "
                         "p99 TTFT ratio")
    args = ap.parse_args(argv)

    cfg = serving_config(args.device)
    max_len, kv_block, prompt_lens = serving_defaults(args.device)
    max_len = args.max_len or max_len
    kv_block = args.kv_block or kv_block
    model = tr.init_params(cfg, torch.Generator().manual_seed(args.seed),
                           device=args.device)
    workload = make_workload(args.seed, args.requests, args.rate,
                             prompt_lens=prompt_lens)
    out = {"device": str(model.device), "replicas": args.replicas,
           "slots": args.slots, "requests": args.requests,
           "rate": args.rate, "max_len": max_len,
           "prompt_lens": list(prompt_lens)}
    if model.device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(model.device)
    arms = [args.policy]
    if args.compare and args.policy != "round_robin":
        arms.append("round_robin")
    for policy in arms:
        fa.reset_launch_counts()
        out[policy] = route_workload(
            cfg, model, workload, policy, args.replicas, args.slots,
            max_len, kv_block=kv_block, seed=args.seed, device=args.device)
        out[policy]["kernel_launches"] = dict(fa.launch_counts)
    if len(arms) == 2:
        a, b = out[arms[0]], out[arms[1]]
        if a["ttft_p99_s"] and b["ttft_p99_s"]:
            out["p99_ttft_ratio"] = a["ttft_p99_s"] / b["ttft_p99_s"]
    out["metrics"] = hvd_metrics.get_registry().snapshot(max_events=8)
    print(json.dumps(out, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
