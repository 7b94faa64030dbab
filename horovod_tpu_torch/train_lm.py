"""Train the flagship transformer LM through the port: the bench LM leg.

    python -m horovod_tpu_torch.train_lm [--device cuda|cpu] [--windows 3]
        [--size tiny|gpt2-small|gpt2-small-tpu|llama-1b] [--dp N] [--tp N]
        [--sp N] [--ep N] [--num-experts E]
        [--attention full|flash|ring|ring_flash|ulysses]
        [--seq-len S] [--vocab-chunk C] [--remat] [--remat-policy P]

    # 2-way tp x 2-way sp with ring-flash attention on 4 CPU workers
    torchrun --nproc_per_node 4 -m horovod_tpu_torch.train_lm \
        --device cpu --size tiny --tp 2 --sp 2 --attention ring_flash

The port of the JAX package's LM benchmark recipe
(``examples/bench_common.py``: ``build_transformer_step``,
``setup_transformer_lm``, ``transformer_lm_metrics``) with the CLI of
``examples/transformer_lm.py``: ``init()``, the mesh (the flags, else
``HOROVOD_MESH``; dp absorbs the workers tp·sp·ep leave), the flagship
``gpt2_small_tpu`` config (flash attention, tied embeddings, bf16
logits) with seeded fp32 master weights placed by ``param_specs``,
``DistributedOptimizer`` (over the mesh's dp axis) around ``AdamW(3e-4,
mu_dtype=bfloat16)``, and ``make_gspmd_multi_step`` over a stacked
``[inner, batch · dp, seq]`` token array from
``numpy.random.RandomState(0)``, placed by ``batch_spec``. One warm-up
window, then ``--windows`` timed windows of ``inner`` optimizer steps
each, every window ending in a read of the loss. ``--num-experts E``
makes every block's MLP a Mixture-of-Experts layer of E experts (top 2,
capacity factor 1.25; ``models/moe.py``), whose experts ``--ep`` shards
over the mesh's 'ep' axis; the loss then adds the load-balance term.

Prints one JSON line: tokens/s per card and ms/step from the best window
(mean and half-spread beside it), MFU against the card's dense-bf16 peak
(H100 SXM 989 TFLOP/s, PCIe 756; none for another card, and none with
experts: ``matmul_flops_per_token`` counts a dense MLP), the first and
last loss, the flash kernel launches per step, and the card's name and
power limit. On CUDA it runs the flagship at batch 16 per card, seq 1024,
10 inner steps; on the CPU (``--device cpu``) a tiny smoke configuration
with no MFU. Launch several workers with torchrun or hvdrun for data
parallelism across cards.

``--eager-allreduce`` trains data-parallel only (tp, sp and ep must be
1) through ``trainer.build_eager_lm_step``: a plain ``AdamW``, and the
gradients averaged by the eager core, one grouped submission per step
(the JAX CLI's ``examples/transformer_lm.py --eager-allreduce``).

``--steps N`` (or ``--checkpoint-dir``) drives the same model,
optimizer and GSPMD step, on any mesh the flags give (dp, tp, sp),
through a loop of N optimizer steps instead of the timed windows, each
batch ``batch × workers`` rows drawn from ``RandomState([seed, step])``
so that a resumed run, at this layout or another of as many workers,
sees the data an uninterrupted one does. With ``--checkpoint-dir`` it
runs the ``trainer.Checkpointer`` contract (the JAX CLI's
``--checkpoint-dir``/``--checkpoint-every``): resume from the newest
commit, an async save every ``--checkpoint-every`` steps, and on
SIGTERM/SIGINT an emergency save at the end of the step and exit 45.
The state is the fp32 masters and AdamW's bf16 ``mu`` and fp32 ``nu`` by
parameter name, each leaf whole: a leaf sharded over tp is gathered
before a save (every rank gets it; each writes the leaves it owns), and
the manifest records the layout (``mesh_layout``). A resume places the
restored leaves on this run's mesh (``restore_on_mesh`` with
``state_specs``), whatever the saving layout, as the JAX CLI does. The
step, the data position and AdamW's step count ride ``extra``. A rank whose step fails because a peer is gone exits with
``RanksLostError.EXIT_CODE`` (44): a ``RanksLostError``, or a failed
collective that the control plane's liveness ledger confirms
(``mpi_ops.lost_ranks``; ``HOROVOD_RANK_LOST_TIMEOUT_SECONDS`` defaults
to 10 here). Any other failure is raised. Rank 0 prints one JSON line
per event (``start`` on every rank, with its pid; ``resume``, ``step``,
``save`` with ``--checkpoint-digest``), which the elastic drill reads;
every rank prints ``done`` (its losses, and the newest save's blocking
and whole ms).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import dataclasses

import numpy as np
import torch

from . import mpi_ops, optim, trainer
from .common import state as state_mod
from .common.exceptions import (PREEMPTED_EXIT_CODE, HorovodError,
                                RanksLostError)
from .models import transformer as tr
from .ops import flash_attention as fa
from .ops import quantization as quant_mod
from .parallel import mesh as mesh_lib
from .parallel import tensor_parallel as tpl
from .utils import checkpoint as hvd_checkpoint
from .utils import costmodel

# NVIDIA's published dense bf16 tensor-core peaks, by H100 variant

# (batch per dp way, seq, inner steps): the flagship on the card, a smoke
# run on the CPU
DEFAULTS = {"cuda": (16, 1024, 10), "cpu": (2, 64, 2)}

SIZES = {"tiny": tr.TransformerConfig.tiny,
         "gpt2-small": tr.TransformerConfig.gpt2_small,
         "gpt2-small-tpu": tr.TransformerConfig.gpt2_small_tpu,
         "llama-1b": tr.TransformerConfig.llama_1b}


def peak_bf16_flops(device):
    """The card's dense-bf16 peak (``costmodel.peak_flops``), or None on
    the CPU and on a card the ChipSpec table does not know."""
    if device.type != "cuda":
        return None
    return costmodel.peak_flops(device)


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


def flagship_config(on_card, size=None, **overrides):
    """gpt2_small_tpu with flash attention, tied embeddings and bf16
    logits on the card; the tiny config on the CPU; ``size`` (a key of
    SIZES) picks another, ``overrides`` replace fields."""
    kw = dict(attention_impl="flash", tie_embeddings=True, logits_fp32=False)
    kw.update(overrides)
    if size is None:
        size = "gpt2-small-tpu" if on_card else "tiny"
    return SIZES[size](**kw)


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


def build_gspmd_step(cfg, batch, seq, inner, device, mesh, vocab_chunk=0,
                     seed=0):
    """The training model placed on ``mesh`` by ``param_specs``, its
    wrapped optimizer (averaging over the mesh's dp axis), the GSPMD
    multi-step and the whole stacked tokens ``[inner, batch · dp, seq]``
    (every worker the same; the step places them by ``batch_spec``)."""
    model = tr.init_params(cfg, torch.Generator().manual_seed(seed),
                           device=device, train=True)
    specs = tr.param_specs(model)
    trainer.place(model, mesh, specs)
    opt = optim.DistributedOptimizer(
        optim.AdamW(model.parameters(), 3e-4, mu_dtype=torch.bfloat16),
        named_parameters=model.named_parameters())
    trainer.init_opt_state(opt, model)
    step, _, _ = trainer.make_gspmd_multi_step(
        tr.lm_loss_fn(model, vocab_chunk=vocab_chunk), opt, mesh, specs,
        tr.batch_spec(sp=mesh_lib.mesh_axis_size(mesh, "sp") > 1))
    dp = mesh_lib.mesh_axis_size(mesh, "dp")
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                            (inner, batch * dp, seq),
                                            dtype=np.int64)
    return model, opt, step, torch.from_numpy(toks).to(device)


def mesh_of(args):
    """The mesh of the flags (dp inferred when not given), or of
    ``HOROVOD_MESH`` and its per-axis knobs when no flag is given."""
    if (args.dp is not None or args.tp != 1 or args.sp != 1 or
            args.ep != 1):
        return mesh_lib.build_mesh(dp=args.dp, tp=args.tp, sp=args.sp,
                                   ep=args.ep)
    return mesh_lib.mesh_from_env()


def transformer_lm_metrics(window_s, meta, peak_flops=None):
    """Per-window seconds/step folded into the metrics: the best window
    for tokens/s and MFU, the mean and half-spread beside it. No MFU for
    a config with experts: ``matmul_flops_per_token`` counts a dense
    MLP."""
    best = min(window_s)
    mean = sum(window_s) / len(window_s)
    tps = meta["batch_per_chip"] * meta["seq"] / best
    flops = tr.matmul_flops_per_token(meta["cfg"], meta["seq"])
    dense = meta["cfg"].num_experts == 0
    return {
        "model": meta["model"],
        "tokens_per_sec_per_chip": tps,
        "mfu": tps * flops / peak_flops if peak_flops and dense else None,
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
    p.add_argument("--inner-steps", type=int, default=None,
                   help="optimizer steps per window (default 10 on the "
                        "card, 2 on the CPU)")
    p.add_argument("--size", default=None, choices=sorted(SIZES),
                   help="model (default: gpt2-small-tpu on the card, tiny "
                        "on the CPU)")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel ways (default: workers / tp / sp)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel ways")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ways (ring/ulysses attention)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel ways (MoE experts shard over 'ep')")
    p.add_argument("--num-experts", type=int, default=0,
                   help="experts per MoE layer; 0 = dense MLP")
    p.add_argument("--attention", default="flash",
                   choices=["full", "ring", "ring_flash", "ulysses",
                            "flash"])
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--vocab-chunk", type=int, default=0,
                   help="compute the loss blockwise over this many vocab "
                        "entries instead of materializing [B,S,V] logits")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block in the backward")
    p.add_argument("--remat-policy", default=None,
                   choices=["dots", "dots_no_batch"],
                   help="what --remat saves (default: nothing)")
    p.add_argument("--steps", type=int, default=None,
                   help="drive the step through a loop of this many "
                        "optimizer steps instead of the timed windows")
    p.add_argument("--seed", type=int, default=0,
                   help="weights (and the --steps loop's batches)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="trainer.Checkpointer contract on the --steps loop: "
                        "auto-resume, async saves, SIGTERM -> emergency "
                        "save and exit 45")
    p.add_argument("--checkpoint-every", type=int, default=100,
                   help="save an async checkpoint every N steps")
    p.add_argument("--checkpoint-digest", action="store_true",
                   help="rank 0 prints the crc32 digest of the state at "
                        "every save and resume")
    p.add_argument("--num-layers", type=int, default=None,
                   help="cut the model's depth to this many blocks")
    p.add_argument("--wire-check", default=None,
                   help="with --eager-allreduce: each rank saves the "
                        "compensated input and the result of its last "
                        "quantized bucket (their first 2^20 elements), its "
                        "launches and wire bytes per step to "
                        "DIR/rank<r>.pt")
    p.add_argument("--eager-allreduce", action="store_true",
                   help="average gradients through the EAGER collective "
                        "core (one fused allreduce submission per step) "
                        "instead of the GSPMD step's DistributedOptimizer. "
                        "Pure data-parallel only (tp/sp/ep must be 1).")
    return p.parse_args(argv)


def build_eager(args, cfg, batch, seq, inner, device):
    """The ``--eager-allreduce`` path: ``trainer.build_eager_lm_step`` on
    this worker's rows of the tokens, driven ``inner`` steps per window.
    Returns (window, mesh)."""
    mesh = mesh_of(args)
    for axis in ("tp", "sp", "ep"):
        if mesh_lib.mesh_axis_size(mesh, axis) != 1:
            raise SystemExit("--eager-allreduce is pure data-parallel: "
                             "tp/sp/ep must all be 1")
    step, model, opt, toks = trainer.build_eager_lm_step(
        cfg, batch, seq, device, inner=inner)
    optim.broadcast_parameters(model.state_dict(), root_rank=0)

    def window():
        loss = None
        for i in range(inner):
            loss = step(toks[i])
        if mpi_ops.size() > 1:
            loss = mpi_ops.allreduce(loss, average=True)
        return loss
    return window, mesh


def wire_per_step(inner):
    """The eager core's wire bytes per step over the last window, from
    the quantization tally: encoded and full-width, in all and by
    codec."""
    wire, raw, by_codec = 0, 0, {}
    for key, v in quant_mod.tally().items():
        if key[0] == "hvd_wire_bytes_total":
            wire += v
            by_codec[key[1]] = by_codec.get(key[1], 0) + v / inner
        elif key[0] == "hvd_wire_raw_bytes_total":
            raw += v
    return {"bytes": wire / inner, "raw_bytes": raw / inner,
            "by_codec": by_codec}


WIRE_CHECK_ELEMENTS = 1 << 20


def save_wire_check(directory, coord, out):
    """``--wire-check``: this rank's record of its last quantized bucket
    (whole blocks, so the prefix is its own allreduce), launches and wire
    bytes, to ``directory/rank<r>.pt``."""
    rec = coord.last_quantized
    if rec is None:
        raise SystemExit("--wire-check: no quantized bucket ran (set "
                         "HOROVOD_COMPRESSION=int8 or fp8)")
    os.makedirs(directory, exist_ok=True)
    n = WIRE_CHECK_ELEMENTS
    torch.save({"names": rec["names"], "codec": rec["codec"],
                "comp": rec["comp"][:n].float().cpu(),
                "out": rec["out"][:n].float().cpu(),
                "compensated": rec["compensated"],
                "launches_per_step": out["launches_per_step"],
                "wire": out["wire"]},
               os.path.join(directory, f"rank{mpi_ops.rank()}.pt"))


# -- the --steps loop and its checkpoint contract -----------------------------


def batch_at(seed, step, vocab, rows, seq):
    """The tokens ``[1, rows, seq]`` of optimizer step ``step``, a draw of
    ``RandomState([seed, step])``: every worker passes the same, and the
    GSPMD step places each dp way's rows."""
    toks = np.random.RandomState([seed, step]).randint(
        0, vocab, (1, rows, seq), dtype=np.int64)
    return torch.from_numpy(toks)


def _whole(t):
    """``t`` whole: a DTensor sharded over the mesh is gathered over each
    sharding mesh axis's process group, innermost first (every rank of
    the group takes part and gets the whole leaf); a replicated DTensor
    or a plain tensor is its local value, no communication. The gathers
    are the groups' own all_gather (DTensor's functional collectives
    crash gloo over CUDA tensors, which ranks sharing a card use)."""
    from torch.distributed.tensor import DTensor
    from .parallel.ring import GroupRing
    if not isinstance(t, DTensor):
        return t
    local = t.to_local()
    for mesh_dim in reversed(range(len(t.placements))):
        placement = t.placements[mesh_dim]
        if placement.is_shard():
            group = t.device_mesh.get_group(mesh_dim)
            local = GroupRing(group).all_gather(local, placement.dim)
    return local


@torch.no_grad()
def state_tree(model, opt):
    """The training state as a nested dict of whole leaves: the
    parameters (fp32 masters) and AdamW's ``mu``/``nu`` by parameter
    name. Leaves sharded over tp (or any mesh axis) are gathered, so
    every rank holds every leaf whole and ``CheckpointManager``'s ranks
    each write the whole leaves they own: the files are the JAX
    package's, and any layout restores them. Collective on a sharded
    mesh: every rank calls it at the same point."""
    names = {p: n for n, p in model.named_parameters()}
    moments = {}
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state.get(p)
            if st:
                moments[names[p]] = {"mu": _whole(st["mu"]),
                                     "nu": _whole(st["nu"])}
    return {"params": {n: _whole(p.detach())
                       for n, p in model.named_parameters()},
            "opt": moments}


def state_specs(model, opt):
    """The PartitionSpec tree of ``state_tree``: each parameter's
    ``param_specs`` entry, and its AdamW moments on the same spec."""
    specs = tr.param_specs(model)
    names = {p: n for n, p in model.named_parameters()}
    moments = {names[p]: {"mu": specs[names[p]], "nu": specs[names[p]]}
               for group in opt.param_groups for p in group["params"]
               if opt.state.get(p)}
    return {"params": specs, "opt": moments}


@torch.no_grad()
def load_state(model, opt, tree, extra):
    """Copy a restored ``state_tree`` (and AdamW's step count from
    ``extra``) into the model and the optimizer: each leaf's local shard
    (the tree placed on this run's mesh by ``state_specs``, or whole)
    into the matching shard."""
    params = dict(model.named_parameters())
    for n, t in tree["params"].items():
        tpl.local(params[n]).copy_(tpl.local(t))
    for n, moments in tree["opt"].items():
        st = opt.state[params[n]]
        tpl.local(st["mu"]).copy_(tpl.local(moments["mu"]))
        tpl.local(st["nu"]).copy_(tpl.local(moments["nu"]))
        st["step"] = int(extra["adam_step"])


def _lost_ranks(exc):
    """The peers whose loss failed this rank's step, or None when it
    failed for another reason: a RanksLostError names them; a failed
    collective (gloo and NCCL raise RuntimeError) is put to the control
    plane's liveness verdict. Everything else is no loss."""
    if isinstance(exc, RanksLostError):
        return list(exc.ranks)
    if isinstance(exc, RuntimeError):
        return mpi_ops.lost_ranks() or None
    return None


def _emit(event, **fields):
    _line({"event": event, **fields})


def _line(record):
    """``record`` as one JSON line in ONE write: ranks under hvdrun share
    a stdout pipe, where a write under PIPE_BUF bytes is atomic but a
    line printed in two writes can take another rank's line inside."""
    sys.stdout.write(json.dumps(record) + "\n")
    sys.stdout.flush()


def _save_ms(ckptr):
    """The newest save's blocking and whole milliseconds, or None."""
    stats = ckptr.manager.stats if ckptr is not None else {}
    if stats.get("save_s") is None:
        return None
    return {"block_ms": stats["block_s"] * 1e3,
            "save_ms": stats["save_s"] * 1e3}


def axis_wire_bytes(cfg, model, mesh, rows, seq):
    """Analytic payload bytes of one step's collectives by mesh axis (the
    JAX CLI's per-axis wire attribution): the dp leg is the gradient
    allreduce (every parameter), the tp leg the Megatron activation
    allreduces (2 forward + 2 backward a layer of one dp way's [rows/dp,
    S, D] residual). Returns (dp bytes, tp bytes), 0 for an axis of 1."""
    dp = mesh_lib.mesh_axis_size(mesh, "dp")
    tp = mesh_lib.mesh_axis_size(mesh, "tp")
    dp_bytes = sum(p.numel() * p.element_size()
                   for p in model.parameters()) if dp > 1 else 0
    tp_bytes = (4 * cfg.num_layers * (rows // dp) * seq * cfg.d_model *
                cfg.dtype.itemsize) if tp > 1 else 0
    return dp_bytes, tp_bytes


def train_loop(args, cfg, model, opt, step, rows, seq, device, mesh):
    """``--steps``: the GSPMD ``step`` driven one optimizer step at a time
    on ``rows`` rows of ``batch_at``, with the checkpoint contract (see
    the module docstring) on ``mesh``: saved with its layout, resumed
    from a save of any layout through ``restore_on_mesh``. Returns the
    final record."""
    n, rank = mpi_ops.size(), mpi_ops.rank()
    steps = args.steps if args.steps is not None else 20
    _emit("start", rank=rank, workers=n, pid=os.getpid(),
          ppid=os.getppid(), t=time.time())
    ckptr, start = None, 0
    digest = args.checkpoint_digest and rank == 0
    if args.checkpoint_dir:
        agree = None
        if n > 1:
            def agree(flag):
                got = mpi_ops.allreduce(
                    torch.tensor([float(flag)], device=device),
                    average=False, name="hvd.ckpt.preempt")
                return got.item() > 0
        ckptr = trainer.Checkpointer(
            args.checkpoint_dir, every=args.checkpoint_every, rank=rank,
            world_size=n, layout=mesh_lib.mesh_layout(mesh), agree=agree)
        t0 = time.perf_counter()
        like = state_tree(model, opt) if ckptr.manager.exists() else None
        tree, start, extra = ckptr.resume(
            like=like, mesh=mesh, spec_tree=state_specs(model, opt))
        if start:
            load_state(model, opt, tree, extra)
            ms = (time.perf_counter() - t0) * 1e3
            # gathering a sharded state is collective: every rank takes
            # part, rank 0 prints
            whole = state_tree(model, opt) if args.checkpoint_digest \
                else None
            if rank == 0:
                _emit("resume", step=start, extra=extra, workers=n,
                      saved_layout=hvd_checkpoint.saved_layout(
                          args.checkpoint_dir, start), ms=ms,
                      digest=hvd_checkpoint.tree_digest(whole)
                      if digest else None)
    # the step's telemetry (trainer.instrument_step): step time, tokens/s
    # and MFU per card, the allocator peak, the compile tracker, the
    # history and alert ticks, HOROVOD_PERF_ATTRIB_EVERY captures
    dense = cfg.num_experts == 0
    timed = trainer.instrument_step(
        step, tokens_per_step=rows * seq // n, name="train_lm",
        flops_per_token=tr.matmul_flops_per_token(cfg, seq) if dense
        else None, device=device)
    dp_bytes, tp_bytes = axis_wire_bytes(cfg, model, mesh, rows, seq)
    losses = []
    t0 = time.perf_counter()
    for i in range(start, steps):
        try:
            toks = batch_at(args.seed, i, cfg.vocab_size, rows,
                            seq).to(device)
            loss = timed(model, opt, toks)[2].item()
            if dp_bytes:
                mesh_lib.account_axis_bytes("dp", dp_bytes)
            if tp_bytes:
                mesh_lib.account_axis_bytes("tp", tp_bytes)
            losses.append(loss)
            if rank == 0:
                _emit("step", step=i + 1, loss=loss, workers=n,
                      t=time.time())
            extra = {"step": i + 1, "data_pos": i + 1,
                     "adam_step": i + 1}
            saved = []

            def state():
                saved.append(state_tree(model, opt))
                return saved[-1]
            if ckptr is not None and ckptr.step_end(i + 1, state, extra):
                if digest:
                    _emit("save", step=i + 1, kind="emergency",
                          digest=hvd_checkpoint.tree_digest(saved[-1]))
                _emit("preempted", rank=rank, step=i + 1,
                      ckpt=_save_ms(ckptr))
                sys.exit(PREEMPTED_EXIT_CODE)
            if saved and digest:
                _emit("save", step=i + 1, kind="async",
                      digest=hvd_checkpoint.tree_digest(saved[-1]))
        except (RuntimeError, HorovodError) as exc:
            lost = _lost_ranks(exc) if n > 1 else None
            if not lost:
                raise
            err = RanksLostError(lost, reason=f"a collective failed: {exc}")
            print(f"train_lm rank {rank}: {err}", file=sys.stderr,
                  flush=True)
            _emit("ranks_lost", rank=rank, step=i + 1, ranks=lost)
            os._exit(RanksLostError.EXIT_CODE)
    if ckptr is not None:
        ckptr.close()
    dt = time.perf_counter() - t0
    out = {"event": "done", "rank": rank, "step": steps,
           "start_step": start, "workers": n,
           "loss_first": losses[0] if losses else None,
           "loss_last": losses[-1] if losses else None,
           "losses": losses,
           "ms_per_step": dt / max(1, steps - start) * 1e3,
           "ckpt": _save_ms(ckptr), "launches": dict(fa.launch_counts),
           "device": str(device)}
    # every rank: the step's loss is the whole batch's, the same on each
    _line(out)
    mesh_lib.reset_global_mesh()
    mpi_ops.shutdown()
    return out


def main(argv=None):
    args = parse_args(argv)
    looped = args.steps is not None or bool(args.checkpoint_dir)
    if looped and args.eager_allreduce:
        raise SystemExit("--steps and --checkpoint-dir drive the GSPMD "
                         "step, not --eager-allreduce")
    if args.checkpoint_dir:
        # the liveness ledger confirms a lost peer (exit 44, _lost_ranks)
        os.environ.setdefault("HOROVOD_RANK_LOST_TIMEOUT_SECONDS", "10")
    mpi_ops.init(device=args.device)
    device = state_mod.device()
    on_card = device.type == "cuda"
    batch, seq, inner = DEFAULTS[device.type]
    seq = args.seq_len or seq
    inner = args.inner_steps or inner
    cfg = flagship_config(on_card, args.size, attention_impl=args.attention,
                          remat=args.remat, remat_policy=args.remat_policy,
                          num_experts=args.num_experts)
    if args.num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    coord = state_mod.global_state().coordinator
    if args.eager_allreduce:
        window, mesh = build_eager(args, cfg, batch, seq, inner, device)
        coord.record_quantized = args.wire_check is not None
    else:
        mesh = mesh_lib.set_global_mesh(mesh_of(args))
        model, opt, step, toks = build_gspmd_step(
            cfg, batch, seq, inner, device, mesh, args.vocab_chunk,
            seed=args.seed)
        if looped:
            # batch rows per worker whatever the layout, so a run resumed
            # at another layout of as many workers sees the same data
            return train_loop(args, cfg, model, opt, step,
                              batch * mpi_ops.size(), seq, device, mesh)

        def window():
            return step(model, opt, toks)[2]
    losses = [window().item()]   # warm-up window: the kernels build here
    window_s = []
    for w in range(args.windows):
        if w == args.windows - 1:
            fa.reset_launch_counts()
            quant_mod.reset_tally()
        t0 = time.perf_counter()
        loss = window()
        losses.append(loss.item())   # the sync point
        window_s.append((time.perf_counter() - t0) / inner)
    # a card works on its dp way's batch rows, its sp way's sequence shard,
    # and shares them with its tp and ep ways: batch / (tp · sp · ep) rows
    # of seq
    shared = mesh.size // mesh.shape["dp"]
    meta = {"batch_per_chip": batch if shared == 1 else batch / shared,
            "seq": seq, "cfg": cfg,
            "model": "gpt2-small-tpu-flash" if on_card else "tiny-smoke"}
    out = transformer_lm_metrics(window_s, meta, peak_bf16_flops(device))
    out.update({
        "inner": inner, "workers": mpi_ops.size(),
        "mesh": mesh_lib.mesh_layout(mesh), "attention": cfg.attention_impl,
        "num_experts": cfg.num_experts,
        "eager_allreduce": args.eager_allreduce,
        "loss_first": losses[0], "loss_last": losses[-1],
        "launches_per_step": {k: v / inner
                              for k, v in sorted(fa.launch_counts.items())},
        "device": str(device),
        "card": card_line() if on_card else None})
    if args.eager_allreduce:
        out["wire"] = wire_per_step(inner)
    if args.wire_check:
        save_wire_check(args.wire_check, coord, out)
    if mpi_ops.rank() == 0:
        print(json.dumps(out), flush=True)
    mesh_lib.reset_global_mesh()
    mpi_ops.shutdown()
    return out


if __name__ == "__main__":
    main()
