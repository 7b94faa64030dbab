"""Serve the transformer LM with continuous batching, on the port.

Generates synthetic open-loop Poisson traffic against the port's serving
engine and reports decode throughput plus per-request latencies — and,
with ``--baseline``, runs the SAME engine in drain (static-batch) mode so
the two scheduling policies are compared at an equal slot budget. Prints
one JSON result line. The counterpart of ``examples/serve_lm.py``.

Usage:
    # the card: GPT-2-small (6 x 128 heads), bf16, flash kernels
    python -m horovod_tpu_torch.serve_lm --device cuda

    # CPU, tiny fp32 config, continuous vs static side by side
    python -m horovod_tpu_torch.serve_lm --device cpu --baseline

    # tensor-parallel serving over 2 cards (or 2 CPU workers), one rank
    # per card; the JSON line (rank 0's) carries the tokens' digest and the
    # KV bytes per card, to hold against the one-card run
    torchrun --nproc_per_node 2 -m horovod_tpu_torch.serve_lm --tp 2
"""

import argparse
import hashlib
import json
import sys
import time

import numpy as np
import torch

from . import mpi_ops
from .models import transformer as tr
from .ops import flash_attention as fa
from .parallel import mesh as mesh_lib
from .serving.engine import ServeEngine
from .serving.queue import AdmissionQueue, Request


def serving_config(device):
    """The LM this entry point serves: the flagship config on the card,
    the tiny fp32 config on the CPU."""
    if torch.device(device).type == "cuda":
        return tr.TransformerConfig.gpt2_small_tpu(attention_impl="flash")
    return tr.TransformerConfig.tiny(dtype=torch.float32,
                                     attention_impl="full")


def serving_defaults(device):
    """(max_len, kv_block, prompt_lens) when the command line gives none.
    On the card, prompts of 16-960 tokens in a 1024-token cache, so
    prefill runs both the one-tile (online) and the multi-tile (lazy)
    kernel; on the CPU, short prompts for the tiny config."""
    if torch.device(device).type == "cuda":
        return 1024, 16, (16, 960)
    return 64, 8, (4, 8)


def make_workload(seed, n_requests, rate, short_tokens=8, long_tokens=40,
                  long_frac=0.25, prompt_lens=(4, 8), temperature=0.0):
    """Open-loop Poisson arrival schedule: [(arrival_step, Request)].

    Exponential inter-arrival gaps at ``rate`` requests per decode step;
    decode lengths bimodal (mostly short, a heavy tail of long)."""
    r = np.random.RandomState(seed)
    t = 0.0
    workload = []
    for i in range(n_requests):
        t += r.exponential(1.0 / rate)
        n_new = long_tokens if r.rand() < long_frac else short_tokens
        plen = int(r.randint(prompt_lens[0], prompt_lens[1] + 1))
        prompt = tuple(int(x) for x in r.randint(1, 250, plen))
        workload.append((t, Request(f"req-{i}", prompt,
                                    max_new_tokens=n_new,
                                    temperature=temperature)))
    return workload


def run_load(engine, workload, max_steps=100000):
    """Drive the engine under the arrival schedule: submit every request
    whose arrival step has passed, then step. Returns (results,
    decode_steps, wall_s)."""
    i = 0
    steps = 0
    results = []
    t0 = time.monotonic()
    while i < len(workload) or engine.active_count or len(engine.queue):
        while i < len(workload) and workload[i][0] <= steps:
            engine.submit(workload[i][1])
            i += 1
        results.extend(engine.step())
        steps += 1
        if steps >= max_steps:
            raise RuntimeError(
                f"load never drained in {max_steps} steps "
                f"({len(results)} done, {engine.active_count} active)")
    return results, steps, time.monotonic() - t0


def serve_workload(cfg, model, workload, policy, num_slots, max_len,
                   kv_block=8, seed=0, device=None, mesh=None):
    """One arm of the comparison: serve ``workload`` under ``policy``
    (on ``mesh``'s tp ranks when given) and summarize throughput +
    latency, the generated tokens' digest and the KV bytes per card. A
    fresh engine per arm."""
    queue = AdmissionQueue(max_depth=len(workload) + 1,
                           admission_timeout_s=1e9)
    engine = ServeEngine(cfg, model, num_slots=num_slots, max_len=max_len,
                         kv_block=kv_block, policy=policy, queue=queue,
                         seed=seed, device=device, mesh=mesh)
    results, steps, wall_s = run_load(engine, workload)
    completed = [r for r in results if r.outcome == "completed"]
    decode_tokens = sum(len(r.tokens) for r in completed)
    ttfts = sorted(r.ttft_s for r in completed if r.ttft_s is not None)

    def pct(q):
        if not ttfts:
            return None
        return ttfts[min(len(ttfts) - 1, int(q * len(ttfts)))]
    if engine.kv.ledger.blocks_in_use:
        raise RuntimeError(f"{engine.kv.ledger.blocks_in_use} KV blocks "
                           f"leaked")
    digest = hashlib.sha256(json.dumps(sorted(
        (r.request_id, list(r.tokens)) for r in results)).encode())
    return {
        "policy": policy,
        "tokens_sha256": digest.hexdigest(),
        "kv_bytes_per_card": engine.kv.per_chip_bytes(),
        "completed": len(completed),
        "failed": len(results) - len(completed),
        "rejected": sum(queue.rejected.values()),
        "decode_tokens": decode_tokens,
        "steps": steps,
        "tokens_per_step": decode_tokens / max(steps, 1),
        "wall_s": wall_s,
        "tokens_per_s": decode_tokens / wall_s if wall_s else 0.0,
        "ttft_p50_s": pct(0.50),
        "ttft_p99_s": pct(0.99),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--rate", type=float, default=0.5,
                    help="mean arrivals per decode step (open loop)")
    ap.add_argument("--max-len", type=int, default=None,
                    help="cache rows per slot (default 1024 on cuda, "
                         "64 on cpu)")
    ap.add_argument("--kv-block", type=int, default=None,
                    help="KV block rows (default 16 on cuda, 8 on cpu)")
    ap.add_argument("--prompt-lens", type=int, nargs=2, default=None,
                    metavar=("MIN", "MAX"),
                    help="prompt length range (default 16 960 on cuda, "
                         "4 8 on cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--baseline", action="store_true",
                    help="also run the drain (static-batch) arm and "
                         "report the speedup")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks (launch one process per "
                         "card, e.g. under torchrun)")
    args = ap.parse_args(argv)
    mesh = None
    if args.tp > 1:
        mpi_ops.init(device=args.device)
        mesh = mesh_lib.build_mesh(tp=args.tp)

    cfg = serving_config(args.device)
    max_len, kv_block, prompt_lens = serving_defaults(args.device)
    max_len = args.max_len or max_len
    kv_block = args.kv_block or kv_block
    prompt_lens = tuple(args.prompt_lens or prompt_lens)
    model = tr.init_params(cfg, torch.Generator().manual_seed(args.seed),
                           device=args.device)
    workload = make_workload(args.seed, args.requests, args.rate,
                             prompt_lens=prompt_lens,
                             temperature=args.temperature)
    out = {"device": str(model.device), "slots": args.slots,
           "requests": args.requests, "rate": args.rate, "max_len": max_len,
           "prompt_lens": list(prompt_lens), "tp": args.tp}
    if model.device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(model.device)
    fa.reset_launch_counts()
    out["continuous"] = serve_workload(
        cfg, model, workload, "continuous", args.slots, max_len,
        kv_block=kv_block, seed=args.seed, device=args.device, mesh=mesh)
    out["continuous"]["kernel_launches"] = dict(fa.launch_counts)
    if args.baseline:
        out["static"] = serve_workload(
            cfg, model, workload, "drain", args.slots, max_len,
            kv_block=kv_block, seed=args.seed, device=args.device,
            mesh=mesh)
        out["speedup_tokens_per_step"] = (
            out["continuous"]["tokens_per_step"] /
            max(out["static"]["tokens_per_step"], 1e-9))
    if mesh is None or mpi_ops.rank() == 0:
        print(json.dumps(out))
    if mesh is not None:
        mpi_ops.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
