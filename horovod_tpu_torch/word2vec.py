"""Distributed skip-gram word2vec through the port: the sparse-gradient
workload.

    python -m horovod_tpu_torch.word2vec [--device cuda|cpu] [--steps N]
        [--eager] [--check-dense]

    # two ranks, the six gathers of a step fused into two allgatherv
    python -m horovod_tpu_torch.run -np 2 python -m \\
        horovod_tpu_torch.word2vec --eager

The port of ``examples/word2vec.py`` at its defaults (vocab 5000, dim
128, 128 pairs per worker and step, 8 negatives, window 2, lr 0.5 scaled
by the process count): skip-gram pairs with negative sampling from a
Zipf corpus made from ``--seed`` (``make_corpus``), an embedding table
whose gradients touch only the rows of the batch, and those gradients
allreduced as ``IndexedSlices`` — values and indices allgathered and
scatter-added (the reference's tensorflow/__init__.py:62-73). With
``--eager`` the three slices of a step (six gathers) go through ONE
``grouped_sparse_allreduce``, which the negotiated coordinator fuses
into two allgatherv collectives (float values, int indices); without it
each slice takes its own ``sparse_allreduce``. Each process draws its
pairs from ``RandomState(seed + rank)``, as the example's eager mode.
The embedding table is uniform in [-0.5, 0.5) from
``RandomState(seed)`` (the example draws it from ``jax.random``).

Prints one JSON line: the first and last smoothed loss, ms/step, the
fused allgather groups per step, and with ``--check-dense`` the largest
difference, on the first step, between ``to_dense`` of the reduced
slices and the dense allreduce of the densified gradients.
"""

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from . import mpi_ops
from .common import state as state_mod
from .ops.sparse import (IndexedSlices, grouped_sparse_allreduce,
                         sparse_allreduce, to_dense)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="horovod_tpu_torch word2vec")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--vocab-size", type=int, default=5000)
    p.add_argument("--embedding-dim", type=int, default=128)
    p.add_argument("--batch-size", type=int, default=128,
                   help="per-worker skip-gram pairs per step")
    p.add_argument("--num-negatives", type=int, default=8)
    p.add_argument("--window", type=int, default=2)
    p.add_argument("--lr", type=float, default=0.5)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--corpus-len", type=int, default=200_000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--eager", action="store_true",
                   help="one grouped_sparse_allreduce per step, whose "
                        "allgathers the negotiated coordinator fuses "
                        "(launch under python -m horovod_tpu_torch.run)")
    p.add_argument("--check-dense", action="store_true",
                   help="on the first step, hold to_dense of the reduced "
                        "slices against the dense allreduce of the "
                        "densified gradients")
    return p.parse_args(argv)


def make_corpus(vocab, n, seed):
    """Zipf-ish token stream with local correlations (so neighbours are
    learnable): tokens come in correlated runs."""
    rng = np.random.RandomState(seed)
    base = rng.zipf(1.3, n).astype(np.int64) % vocab
    # correlate: every even position tends to be followed by token+1
    nxt = np.roll(base, -1)
    mask = rng.rand(n) < 0.5
    nxt[mask] = (base[mask] + 1) % vocab
    out = np.empty(n, np.int32)
    out[0::2] = base[0::2]
    out[1::2] = nxt[0::2][: len(out[1::2])]
    return out


def skipgram_batches(corpus, window, batch, rng):
    centers = rng.randint(window, len(corpus) - window, batch)
    offs = rng.randint(1, window + 1, batch) * rng.choice([-1, 1], batch)
    return corpus[centers], corpus[centers + offs]


def init_tables(vocab, dim, seed, device):
    """(emb, ctx): uniform [-0.5, 0.5) embeddings and zero context
    vectors, fp32."""
    emb = np.random.RandomState(seed).uniform(-0.5, 0.5, (vocab, dim))
    return (torch.from_numpy(emb.astype(np.float32)).to(device),
            torch.zeros((vocab, dim), dtype=torch.float32, device=device))


def loss_fn(c_rows, pos_rows, neg_rows):
    """Negative-sampling loss of [B, D] centers, [B, D] contexts and
    [B, K, D] negatives."""
    pos_logit = torch.sum(c_rows * pos_rows, -1)
    neg_logit = torch.einsum("bd,bkd->bk", c_rows, neg_rows)
    return (-torch.mean(F.logsigmoid(pos_logit))
            - torch.mean(torch.sum(F.logsigmoid(-neg_logit), -1)))


def sparse_grads(emb, ctx, centers, contexts, negs):
    """(loss, [IndexedSlices of emb, of ctx at the contexts, of ctx at
    the negatives]): the gradient rows of one batch."""
    rows = [emb[centers].requires_grad_(), ctx[contexts].requires_grad_(),
            ctx[negs].requires_grad_()]
    loss = loss_fn(*rows)
    g_c, g_pos, g_neg = torch.autograd.grad(loss, rows)
    b = centers.shape[0]
    return loss.detach(), [
        IndexedSlices(g_c, centers, emb.shape),
        IndexedSlices(g_pos, contexts, ctx.shape),
        IndexedSlices(g_neg.reshape(b * negs.shape[1], -1),
                      negs.reshape(-1), ctx.shape)]


def apply(emb, ctx, reduced, lr):
    """Scatter-add ``-lr`` times the reduced rows into the tables, in
    place."""
    g_emb, g_pos, g_neg = reduced
    emb.index_add_(0, g_emb.indices.long(), -lr * g_emb.values)
    ctx.index_add_(0, g_pos.indices.long(), -lr * g_pos.values)
    ctx.index_add_(0, g_neg.indices.long(), -lr * g_neg.values)


def reduce_grads(slices, grouped):
    if grouped:
        return grouped_sparse_allreduce(slices, average=True, name="w2v")
    return [sparse_allreduce(s, average=True, name=f"w2v.{i}")
            for i, s in enumerate(slices)]


def dense_check(slices, reduced):
    """Largest |to_dense(reduced) - allreduce(to_dense(slices))| over the
    emb and ctx gradients, relative to the latter's largest magnitude
    (the emb gradient is zero on the first step, where ctx is)."""
    emb_dense = to_dense(slices[0])
    ctx_dense = to_dense(slices[1]) + to_dense(slices[2])
    want = [mpi_ops.allreduce(emb_dense, average=True, name="w2v.dense.emb"),
            mpi_ops.allreduce(ctx_dense, average=True, name="w2v.dense.ctx")]
    got = [to_dense(reduced[0]), to_dense(reduced[1]) + to_dense(reduced[2])]
    diff = max((g - w).abs().max().item() for g, w in zip(got, want))
    return diff / max(w.abs().max().item() for w in want)


def main(argv=None):
    args = parse_args(argv)
    mpi_ops.init(device=args.device)
    device = state_mod.device()
    nproc, rank = mpi_ops.process_count(), mpi_ops.process_rank()
    corpus = make_corpus(args.vocab_size, args.corpus_len, args.seed)
    emb, ctx = init_tables(args.vocab_size, args.embedding_dim, args.seed,
                           device)
    mpi_ops.broadcast_(emb, 0, name="w2v.emb")
    b, k = args.batch_size, args.num_negatives
    lr = args.lr * nproc
    rng = np.random.RandomState(args.seed + rank)
    coord = state_mod.global_state().coordinator
    out = {"workers": nproc, "steps": args.steps, "eager": args.eager,
           "vocab": args.vocab_size, "dim": args.embedding_dim,
           "device": str(device)}
    avg = first = None
    gathers = None
    t0 = time.perf_counter()
    for i in range(args.steps):
        if i == 1:
            gathers = coord.executed_ops["allgather"]
            t0 = time.perf_counter()
        centers, contexts = skipgram_batches(corpus, args.window, b, rng)
        negs = rng.randint(0, args.vocab_size, (b, k))
        loss, slices = sparse_grads(
            emb, ctx, torch.from_numpy(centers).long().to(device),
            torch.from_numpy(contexts).long().to(device),
            torch.from_numpy(negs).to(device))
        reduced = reduce_grads(slices, args.eager)
        if i == 0 and args.check_dense:
            out["dense_check_max_rel"] = dense_check(slices, reduced)
        apply(emb, ctx, reduced, lr)
        loss = mpi_ops.allreduce(loss, average=True, name="w2v.loss").item()
        avg = loss if avg is None else 0.95 * avg + 0.05 * loss
        first = loss if first is None else first
    steps_timed = max(1, args.steps - 1)
    out.update({
        "loss_first": first, "loss_last": avg,
        "ms_per_step": (time.perf_counter() - t0) / steps_timed * 1e3,
        "allgather_groups_per_step":
            (coord.executed_ops["allgather"] - (gathers or 0)) /
            steps_timed})
    if rank == 0:
        print(json.dumps(out), flush=True)
    mpi_ops.shutdown()
    return out


if __name__ == "__main__":
    main()
