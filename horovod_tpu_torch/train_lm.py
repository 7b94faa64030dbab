"""Train the flagship transformer LM through the port: the bench LM leg.

    python -m horovod_tpu_torch.train_lm [--device cuda|cpu] [--windows 3]

The port of the JAX package's LM benchmark recipe
(``examples/bench_common.py``: ``build_transformer_step``,
``setup_transformer_lm``, ``transformer_lm_metrics``) with the CLI of
``examples/transformer_lm.py``: ``init()``, the flagship
``gpt2_small_tpu`` config (flash attention, tied embeddings, bf16
logits) with seeded fp32 master weights, ``DistributedOptimizer`` around
``AdamW(3e-4, mu_dtype=bfloat16)``, ``broadcast_parameters``, and
``make_multi_step`` over a stacked ``[inner, batch, seq]`` token array
from ``numpy.random.RandomState(0)`` (each worker takes its slice of the
global batch). One warm-up window, then ``--windows`` timed windows of
``inner`` optimizer steps each, every window ending in a read of the loss.

Prints one JSON line: tokens/s per card and ms/step from the best window
(mean and half-spread beside it), MFU against the card's dense-bf16 peak
(H100 SXM 989 TFLOP/s, PCIe 756; none for another card), the first and
last loss, the flash kernel launches per step, and the card's name and
power limit. On CUDA it runs the flagship at batch 16 per card, seq 1024,
10 inner steps; on the CPU (``--device cpu``) a tiny smoke configuration
with no MFU. Launch several workers with torchrun or hvdrun for data
parallelism across cards.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from . import mpi_ops, optim, trainer
from .common import state as state_mod
from .models import transformer as tr
from .ops import flash_attention as fa

# NVIDIA's published dense bf16 tensor-core peaks, by H100 variant
H100_PEAK_BF16 = {"sxm": 989e12, "pcie": 756e12}

# (batch per card, seq, inner steps): the flagship on the card, a smoke
# run on the CPU
DEFAULTS = {"cuda": (16, 1024, 10), "cpu": (2, 64, 2)}


def peak_bf16_flops(device):
    """The card's dense-bf16 peak, or None when it is not an H100."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    if "H100" not in name:
        return None
    return H100_PEAK_BF16["pcie" if "PCIe" in name else "sxm"]


def card_line():
    """``name, power.limit`` of the first card as nvidia-smi gives them,
    or None where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def flagship_config(on_card):
    """gpt2_small_tpu with flash attention, tied embeddings and bf16
    logits on the card; the tiny config on the CPU."""
    kw = dict(attention_impl="flash", tie_embeddings=True, logits_fp32=False)
    if on_card:
        return tr.TransformerConfig.gpt2_small_tpu(**kw)
    return tr.TransformerConfig.tiny(**kw)


def build_transformer_step(cfg, batch, seq, inner, device, seed=0):
    """The training model, its wrapped optimizer, the multi-step and this
    worker's stacked tokens ``[inner, batch, seq]``."""
    model = tr.init_params(cfg, torch.Generator().manual_seed(seed),
                           device=device, train=True)
    opt = optim.DistributedOptimizer(
        optim.AdamW(model.parameters(), 3e-4, mu_dtype=torch.bfloat16),
        named_parameters=model.named_parameters())
    optim.broadcast_parameters(model.state_dict(), root_rank=0)
    step = trainer.make_multi_step(model, opt, tr.lm_loss_fn(model))
    n, r = mpi_ops.size(), mpi_ops.rank()
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (inner, batch * n, seq),
                       dtype=np.int64)[:, r * batch:(r + 1) * batch]
    return model, opt, step, torch.from_numpy(toks.copy()).to(device)


def transformer_lm_metrics(window_s, meta, peak_flops=None):
    """Per-window seconds/step folded into the metrics: the best window
    for tokens/s and MFU, the mean and half-spread beside it."""
    best = min(window_s)
    mean = sum(window_s) / len(window_s)
    tps = meta["batch_per_chip"] * meta["seq"] / best
    flops = tr.matmul_flops_per_token(meta["cfg"], meta["seq"])
    return {
        "model": meta["model"],
        "tokens_per_sec_per_chip": tps,
        "mfu": tps * flops / peak_flops if peak_flops else None,
        "seq_len": meta["seq"],
        "batch_per_chip": meta["batch_per_chip"],
        "ms_per_step": best * 1e3,
        "ms_per_step_mean": mean * 1e3,
        "ms_per_step_pm": (max(window_s) - min(window_s)) / 2 * 1e3,
        "windows": len(window_s),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="horovod_tpu_torch LM training")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--windows", type=int, default=3,
                   help="timed windows after the warm-up window")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    mpi_ops.init(device=args.device)
    device = state_mod.device()
    on_card = device.type == "cuda"
    batch, seq, inner = DEFAULTS[device.type]
    cfg = flagship_config(on_card)
    _, _, step, toks = build_transformer_step(cfg, batch, seq, inner, device)
    losses = [step(toks).item()]   # warm-up window: the kernels build here
    window_s = []
    for w in range(args.windows):
        if w == args.windows - 1:
            fa.reset_launch_counts()
        t0 = time.perf_counter()
        loss = step(toks)
        losses.append(loss.item())   # the sync point
        window_s.append((time.perf_counter() - t0) / inner)
    meta = {"batch_per_chip": batch, "seq": seq, "cfg": cfg,
            "model": "gpt2-small-tpu-flash" if on_card else "tiny-smoke"}
    out = transformer_lm_metrics(window_s, meta, peak_bf16_flops(device))
    out.update({
        "inner": inner, "workers": mpi_ops.size(),
        "loss_first": losses[0], "loss_last": losses[-1],
        "launches_per_step": {k: v / inner
                              for k, v in sorted(fa.launch_counts.items())},
        "device": str(device),
        "card": card_line() if on_card else None})
    if mpi_ops.rank() == 0:
        print(json.dumps(out), flush=True)
    mpi_ops.shutdown()
    return out


if __name__ == "__main__":
    main()
