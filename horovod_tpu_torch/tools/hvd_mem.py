"""hvd_mem: pre-flight HBM planning and memory-plane selftest.

The port of ``tools/hvd_mem.py``, the front door of the memory & compile
plane (``horovod_tpu_torch/utils/memory.py``):

  * ``--plan``: the pre-flight estimate ("does this model fit at dp 2,
    tp 4 on an H100?") from pure math: the parameter shapes (the model
    built on the ``meta`` device), the declared ``param_specs`` and the
    costmodel ChipSpec table; no card touched. Prints the per-card
    component table and a fits/overflow verdict; exits 1 on overflow so
    launch scripts can gate.
  * ``--flight dump.json``: print the ``memory`` section a flight dump
    carries (HBM ledger snapshot + per-site compile summary).
  * ``--selftest``: a CPU pass over the whole plane: planner math, the
    ledger's round trip, the recompile-storm ladder, and the resharding
    sentinel over recorded collectives (a full-shape gather of a
    declared-sharded parameter must be named; a clean record must not).

Usage:
    python -m horovod_tpu_torch.tools.hvd_mem --plan --model gpt2_small_tpu \\
        --dp 2 --tp 4 --chip h100 [--batch-per-chip 8] [--seq 1024] \\
        [--optimizer adam] [--kv-slots 8] [--kv-max-len 1024]
    python -m horovod_tpu_torch.tools.hvd_mem --flight flight-rank0.json
    python -m horovod_tpu_torch.tools.hvd_mem --selftest
"""

import argparse
import json
import sys

import torch

from ..utils import memory as hvd_memory

MODELS = ("tiny", "gpt2_small", "gpt2_small_tpu", "llama_1b")

# CLI names -> the device-name prefixes the ChipSpec table matches on;
# other strings pass through, so a card's own name works too
CHIP_ALIASES = {"h100": "NVIDIA H100 80GB HBM3",
                "h100-sxm": "NVIDIA H100 80GB HBM3",
                "h100-pcie": "NVIDIA H100 PCIe"}

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _fmt_bytes(n):
    if n is None:
        return "-"
    sign = "-" if n < 0 else ""
    n = abs(float(n))
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return (f"{sign}{n:.0f} {unit}" if unit == "B"
                    else f"{sign}{n:.2f} {unit}")
        n /= 1024
    return None  # pragma: no cover - the loop always returns


def cmd_plan(args):
    from ..models import transformer as tr

    kw = {}
    if args.dtype:
        kw["dtype"] = DTYPES[args.dtype]
    cfg = getattr(tr.TransformerConfig, args.model)(**kw)
    chip = CHIP_ALIASES.get((args.chip or "").lower(), args.chip)
    plan = hvd_memory.plan_memory(
        cfg, dp=args.dp, tp=args.tp, sp=args.sp,
        batch_per_chip=args.batch_per_chip, seq=args.seq,
        chip=chip, optimizer=args.optimizer,
        kv_slots=args.kv_slots, kv_max_len=args.kv_max_len)
    if args.json:
        print(json.dumps(plan, indent=2, sort_keys=True))
    else:
        layout = plan["layout"]
        print(f"hvd_mem plan: {args.model} @ dp={layout['dp']} "
              f"tp={layout['tp']} sp={layout['sp']}, "
              f"batch/chip={plan['batch_per_chip']}, seq={plan['seq']}"
              + (f", chip={plan['chip']}" if plan["chip"] else ""))
        for component in hvd_memory.COMPONENTS:
            if component in plan["components"]:
                print(f"  {component:<12} "
                      f"{_fmt_bytes(plan['components'][component]):>12}")
        print(f"  {'total':<12} {_fmt_bytes(plan['total_bytes']):>12}")
        if plan["capacity_bytes"] is not None:
            print(f"  {'capacity':<12} "
                  f"{_fmt_bytes(plan['capacity_bytes']):>12}")
            print(f"  {'headroom':<12} "
                  f"{_fmt_bytes(plan['headroom_bytes']):>12}")
            print("  verdict: " + ("FITS" if plan["fits"]
                                   else "DOES NOT FIT"))
        else:
            print("  verdict: no chip given (--chip h100|h100-pcie) — "
                  "no capacity to compare against")
    return 0 if plan["fits"] is not False else 1


def cmd_flight(path):
    with open(path) as f:
        dump = json.load(f)
    section = dump.get("memory")
    if not section:
        print(f"{path}: no memory section (plane disabled, or nothing "
              f"accounted before the dump)")
        return 1
    hbm = section.get("hbm")
    if hbm:
        print(f"{path}: HBM ledger")
        for component, nbytes in sorted(
                (hbm.get("components") or {}).items()):
            print(f"  {component:<12} {_fmt_bytes(nbytes):>12}")
        print(f"  {'total':<12} {_fmt_bytes(hbm.get('total_bytes')):>12}")
        if hbm.get("capacity_bytes") is not None:
            print(f"  {'headroom':<12} "
                  f"{_fmt_bytes(hbm.get('headroom_bytes')):>12}")
    compile_summary = section.get("compile")
    if compile_summary:
        print("compile sites:")
        for site, entry in sorted(compile_summary.items()):
            storm = "  STORMING" if entry.get("storming") else ""
            print(f"  {site:<24} hits={entry.get('hits', 0)} "
                  f"misses={entry.get('misses', 0)}{storm}")
            if entry.get("storming") and entry.get("last_key"):
                print(f"    last missed key: {entry['last_key']}")
    return 0


def _check(cond, what):
    if not cond:
        raise AssertionError(f"hvd_mem --selftest: {what}")


def selftest():
    """One CPU pass over every surface of the plane."""
    from ..models import transformer as tr
    from ..parallel.mesh import P

    # 1. planner math: tp=2 must shrink the params the specs shard
    cfg = tr.TransformerConfig.tiny()
    plan1 = hvd_memory.plan_memory(cfg, dp=1, tp=1, chip="cpu",
                                   batch_per_chip=2, seq=64)
    plan2 = hvd_memory.plan_memory(cfg, dp=1, tp=2, chip="cpu",
                                   batch_per_chip=2, seq=64)
    _check(plan1["components"]["params"] > 0, "no params planned")
    _check(plan2["components"]["params"] < plan1["components"]["params"],
           "tp=2 did not shrink the params")
    _check(plan1["capacity_bytes"] is not None and plan1["fits"] is True,
           "the tiny plan does not fit the cpu row")

    # 2. ledger attribution round trip against hand math
    hvd_memory.reset(enabled=True)
    ledger = hvd_memory.get_ledger()
    ledger.account_tree("params", {"w": torch.zeros(16, 32)})
    snap = ledger.snapshot()
    _check(snap["components"]["params"] == 16 * 32 * 4, snap)
    _check(snap["total_bytes"] == 16 * 32 * 4, snap)

    # 3. recompile-storm ladder: a new key every call must escalate, a
    #    stable site must not
    tracker = hvd_memory.CompileTracker(decay=0.5, threshold=0.4,
                                        min_misses=3)
    for n in range(1, 7):
        tracker.observe("selftest:storm", (torch.zeros(n),))
    summary = tracker.site_summary()["selftest:storm"]
    _check(summary["storming"] and summary["misses"] == 6, summary)
    for _ in range(6):
        tracker.observe("selftest:stable", (torch.zeros(8),))
    _check(not tracker.site_summary()["selftest:stable"]["storming"],
           "a stable site storms")

    # 4. resharding sentinel: a full-shape gather of a parameter declared
    #    sharded over tp is named; the declared layout is silent
    params = {"w": torch.zeros(8, 16)}
    specs = {"w": P("tp", None)}
    bad = [{"op": "all-gather", "result_shape": (8, 16),
            "operand_shapes": [(4, 16)], "dim": 0}]
    found = hvd_memory.scan_resharding(bad, params, specs, {"tp": 2},
                                       site="selftest:bad")
    _check(len(found) == 1 and found[0]["leaf"] == "w" and
           found[0]["axis"] == "tp", found)
    clean = [{"op": "all-reduce", "result_shape": (4, 16),
              "operand_shapes": [(4, 16)], "dim": None}]
    _check(hvd_memory.scan_resharding(clean, params, specs, {"tp": 2},
                                      site="selftest:clean") == [],
           "a clean record was flagged")
    hvd_memory.reset()
    print("hvd_mem --selftest: ok (plan math, ledger round-trip, "
          "storm ladder, resharding sentinel)")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Pre-flight HBM planning and memory-plane selftest")
    ap.add_argument("--plan", action="store_true",
                    help="print the per-card HBM estimate for a layout")
    ap.add_argument("--model", choices=MODELS, default="gpt2_small_tpu")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--batch-per-chip", type=int, default=1)
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default: min(max_seq_len, 128))")
    ap.add_argument("--chip", default=None,
                    help="ChipSpec kind for capacity (h100, h100-pcie, or "
                         "a card's name)")
    ap.add_argument("--optimizer", default="adam",
                    choices=("adam", "adamw", "sgd", "none"))
    ap.add_argument("--kv-slots", type=int, default=0,
                    help="serving: KV-cache slots to plan for")
    ap.add_argument("--kv-max-len", type=int, default=0,
                    help="serving: KV-cache max length per slot")
    ap.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                    help="override the config dtype")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable plan output")
    ap.add_argument("--flight", metavar="DUMP",
                    help="print the memory section of a flight dump")
    ap.add_argument("--selftest", action="store_true",
                    help="exercise the whole plane on the CPU")
    args = ap.parse_args(argv)

    if args.selftest:
        return selftest()
    if args.flight:
        return cmd_flight(args.flight)
    if args.plan:
        return cmd_plan(args)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
